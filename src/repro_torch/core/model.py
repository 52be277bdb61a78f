"""DWN model: thermometer encoder -> LUT layer stack -> popcount classifier.

The PyTorch counterpart of ``repro.core.model``: the differentiable
training forward and loss, the frozen hardware model and its paths.  The JSC
variants of the paper (one LUT layer each) are the presets:

    sm-10   m=10      sm-50   m=50
    md-360  m=360     lg-2400 m=2400

all with F=16 features, T=200 thermometer bits/feature, n=6 LUT fan-in and 5
classes.  Multi-layer stacks are supported: layer l+1 draws its candidate
bits from layer l's outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .classifier import (cross_entropy, group_popcount,
                         group_popcount_packed, logits_from_counts, predict)
from .lut_layer import (LUTLayerSpec, binarize_tables, finalize_mapping,
                        init_lut_layer, lut_eval_hard, lut_eval_hard_packed,
                        lut_layer_apply, lut_layer_apply_stopgrad)
from .thermometer import (ThermometerSpec, encode, encode_packed,
                          fit_thresholds, quantize_fixed_point, to_numpy)


@dataclasses.dataclass(frozen=True)
class DWNConfig:
    num_features: int = 16
    bits_per_feature: int = 200
    encoding: str = "distributive"          # threshold placement
    lut_counts: tuple = (50,)               # per LUT layer; last % classes == 0
    fan_in: int = 6
    num_classes: int = 5
    tau: float | None = None                # softmax temperature; None = auto

    @property
    def thermometer(self) -> ThermometerSpec:
        return ThermometerSpec(self.num_features, self.bits_per_feature,
                               self.encoding)

    @property
    def group_size(self) -> int:
        return self.lut_counts[-1] // self.num_classes

    @property
    def tau_value(self) -> float:
        if self.tau is not None:
            return self.tau
        return max(0.3, self.group_size / 12.0)

    def layer_specs(self) -> list[LUTLayerSpec]:
        if self.lut_counts[-1] % self.num_classes != 0:
            raise ValueError(f"last layer width {self.lut_counts[-1]} does "
                             f"not split into {self.num_classes} classes")
        specs, C = [], self.thermometer.total_bits
        for m in self.lut_counts:
            specs.append(LUTLayerSpec(m, self.fan_in, C))
            C = m
        return specs


# Paper presets (Table I / §II): name -> lut count of the single LUT layer.
JSC_PRESETS = {
    "sm-10": DWNConfig(lut_counts=(10,)),
    "sm-50": DWNConfig(lut_counts=(50,)),
    "md-360": DWNConfig(lut_counts=(360,)),
    "lg-2400": DWNConfig(lut_counts=(2400,)),
}


# Baseline accuracies the paper holds PTQ to (§III).
PAPER_BASELINE_ACC = {"sm-10": 0.711, "sm-50": 0.740, "md-360": 0.756,
                      "lg-2400": 0.763}


def init_dwn(generator: torch.Generator, cfg: DWNConfig,
             x_train: np.ndarray, *, device="cpu"):
    """Returns (params, buffers): params trainable, buffers = thresholds.

    The LUT parameters come from ``generator``, which draws other numbers
    than the reference's ``jax.random`` key: the same seed gives another
    model.  Use :func:`params_from_numpy` to carry the reference's
    parameters across.
    """
    thresholds = fit_thresholds(x_train, cfg.thermometer)
    layers = [init_lut_layer(generator, s, device=device)
              for s in cfg.layer_specs()]
    return ({"layers": layers},
            {"thresholds": torch.from_numpy(thresholds).to(device)})


def params_from_numpy(params, buffers, *, device="cpu"):
    """The reference's ``{"layers": [{"scores", "tables"}]}`` and
    ``{"thresholds"}`` (as numpy arrays, or anything ``np.asarray`` takes)
    -> the port's params and buffers as float32 tensors on ``device``."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    layers = [{"scores": t(l["scores"]), "tables": t(l["tables"])}
              for l in params["layers"]]
    return {"layers": layers}, {"thresholds": t(buffers["thresholds"])}


def apply_train_from_bits(params, cfg: DWNConfig,
                          bits: torch.Tensor) -> torch.Tensor:
    """Differentiable forward from pre-encoded bits: (B, F*T) -> logits.

    ``bits`` may be any dtype holding {0, 1} (the engine keeps uint8
    rows); they are cast to float32 and take no gradient, since the
    thermometer thresholds are never trained.
    """
    with torch.no_grad():
        bits = bits.to(torch.float32)
    for i, layer in enumerate(params["layers"]):
        bits = (lut_layer_apply_stopgrad(layer, bits) if i == 0
                else lut_layer_apply(layer, bits))
    counts = group_popcount(bits, cfg.num_classes)
    return logits_from_counts(counts, cfg.tau_value)


def apply_train(params, buffers, cfg: DWNConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Differentiable forward: raw features -> class logits."""
    return apply_train_from_bits(params, cfg,
                                 encode(x, buffers["thresholds"]))


def loss_fn(params, buffers, cfg: DWNConfig, x: torch.Tensor,
            y: torch.Tensor):
    """(cross-entropy, logits) of features ``x`` against labels ``y``."""
    logits = apply_train(params, buffers, cfg, x)
    return cross_entropy(logits, y), logits


def loss_fn_from_bits(params, cfg: DWNConfig, bits: torch.Tensor,
                      y: torch.Tensor):
    """Cross-entropy twin of :func:`loss_fn` over pre-encoded bits."""
    logits = apply_train_from_bits(params, cfg, bits)
    return cross_entropy(logits, y), logits


@dataclasses.dataclass
class FrozenDWN:
    """Hardware-semantics model: what the generator emits as RTL.  The
    array fields are numpy (so a reference ``FrozenDWN``'s arrays build
    one) or tensors on one device (see :func:`frozen_device`)."""
    cfg: DWNConfig
    thresholds: np.ndarray                   # (F, T), possibly quantized
    mapping_idx: list                        # per layer (m, n) int32
    tables_bin: list                         # per layer (m, 2^n) int {0,1}
    input_frac_bits: int | None = None       # (1, n) PEN quantization, None=TEN


def freeze(params, buffers, cfg: DWNConfig,
           input_frac_bits: int | None = None) -> FrozenDWN:
    """Freeze to hardware semantics; PEN quantizes the thresholds with
    numpy, as the reference does."""
    mapping = [finalize_mapping(l).cpu().numpy() for l in params["layers"]]
    tables = [binarize_tables(l).cpu().numpy() for l in params["layers"]]
    th = np.asarray(buffers["thresholds"].cpu().numpy(), np.float32)
    if input_frac_bits is not None:
        th = np.asarray(quantize_fixed_point(th, input_frac_bits))
    return FrozenDWN(cfg, th, mapping, tables, input_frac_bits)


def frozen_device(frozen: FrozenDWN) -> torch.device:
    """Where the frozen model lives: its thresholds' device when they are
    a tensor, else the CPU."""
    th = frozen.thresholds
    return th.device if isinstance(th, torch.Tensor) else torch.device("cpu")


def host_frozen(frozen: FrozenDWN) -> FrozenDWN:
    """``frozen`` with every array field as numpy on the host (tensors on
    any device are copied; numpy fields are kept as they are)."""
    return FrozenDWN(frozen.cfg, to_numpy(frozen.thresholds),
                     [to_numpy(i) for i in frozen.mapping_idx],
                     [to_numpy(t) for t in frozen.tables_bin],
                     frozen.input_frac_bits)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _frozen_tensors(frozen: FrozenDWN, device):
    th = _tensor(frozen.thresholds, device, torch.float32)
    layers = [(_tensor(i, device), _tensor(t, device))
              for i, t in zip(frozen.mapping_idx, frozen.tables_bin)]
    return th, layers


def apply_hard(frozen: FrozenDWN, x: torch.Tensor) -> torch.Tensor:
    """Bit-exact inference path (counts), every bit a float32.  Quantizes
    the inputs for PEN."""
    if frozen.input_frac_bits is not None:
        x = quantize_fixed_point(x, frozen.input_frac_bits)
    th, layers = _frozen_tensors(frozen, x.device)
    bits = encode(x, th)
    for idx, tab in layers:
        bits = lut_eval_hard(bits, idx, tab)
    return group_popcount(bits, frozen.cfg.num_classes)


def apply_hard_packed(frozen: FrozenDWN, x: torch.Tensor) -> torch.Tensor:
    """Packed-bitplane twin of :func:`apply_hard` (same counts); every
    intermediate bit tensor is packed words."""
    if frozen.input_frac_bits is not None:
        x = quantize_fixed_point(x, frozen.input_frac_bits)
    th, layers = _frozen_tensors(frozen, x.device)
    packed = encode_packed(x, th)
    for idx, tab in layers:
        packed = lut_eval_hard_packed(packed, idx, tab)
    return group_popcount_packed(packed, frozen.cfg.num_classes)


def _eval_accuracy(fn, x: np.ndarray, y: np.ndarray, batch: int,
                   device) -> float:
    hits = 0
    for i in range(0, x.shape[0], batch):
        xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch],
                                                   np.float32)).to(device)
        pred = predict(fn(xb)).cpu().numpy()
        hits += int((pred == y[i:i + batch]).sum())
    return hits / x.shape[0]


def eval_accuracy_hard(frozen: FrozenDWN, x: np.ndarray, y: np.ndarray,
                       batch: int = 4096, *, device=None) -> float:
    """Streaming hard-path accuracy (hardware semantics) in [0, 1].  The
    rows go to ``device``, by default where the frozen model lives
    (:func:`frozen_device`)."""
    return _eval_accuracy(lambda xb: apply_hard(frozen, xb), x, y, batch,
                          device or frozen_device(frozen))


def eval_accuracy_hard_packed(frozen: FrozenDWN, x: np.ndarray,
                              y: np.ndarray, batch: int = 4096, *,
                              device=None) -> float:
    """Packed-bitplane twin of :func:`eval_accuracy_hard` (same value)."""
    return _eval_accuracy(lambda xb: apply_hard_packed(frozen, xb), x, y,
                          batch, device or frozen_device(frozen))


__all__ = [
    "DWNConfig", "FrozenDWN", "JSC_PRESETS", "PAPER_BASELINE_ACC",
    "apply_hard",
    "apply_hard_packed", "apply_train", "apply_train_from_bits",
    "eval_accuracy_hard", "eval_accuracy_hard_packed", "freeze",
    "frozen_device", "host_frozen", "init_dwn", "loss_fn",
    "loss_fn_from_bits", "params_from_numpy",
]
