"""Pluggable DWN datapath backends.

A *backend* is one implementation of the serving datapath
``features -> (class counts, argmax)`` over a frozen DWN.  All backends
share the same hardware semantics; they differ in how the bits move:

    fused-packed   one CUDA kernel launch: encode -> LUT layer(s) -> masked
                   popcount -> first argmax, every bit packed and kept in
                   shared memory (``kernels.fused``)
    packed-eager   the same packed word format as plain tensor ops
                   (``core.model.apply_hard_packed``); counterpart of the
                   reference's ``packed-xla``
    float-oracle   ``apply_hard``: every bit a float32.  The bit-exactness
                   oracle every other backend is checked against at engine
                   startup.

``BoundBackend`` binds a backend to one model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.classifier import predict
from ..core.model import DWNConfig, FrozenDWN, apply_hard, apply_hard_packed
from ..core.thermometer import quantize_fixed_point
from ..kernels.fused import ops as fused_ops


@dataclasses.dataclass
class DWNModelBundle:
    """A frozen DWN plus its operands staged on ``device``.

    Every backend reads from the same bundle, so cross-backend comparisons
    compare datapaths, not weights.
    """

    name: str
    dcfg: DWNConfig
    frozen: FrozenDWN
    device: torch.device
    thresholds: torch.Tensor          # (F, T)
    mappings: list                    # per layer (m, n) int32
    tables: list                      # per layer (m, 2^n) int32
    #: bucket -> ``FusedConfig`` the fused backend serves that bucket with
    #: (absent: ``autotune.DEFAULT_CONFIG``); read at every step.
    tuned_configs: dict = dataclasses.field(default_factory=dict)

    @property
    def num_classes(self) -> int:
        return self.dcfg.num_classes

    @property
    def arch_name(self) -> str:
        return self.name


class Backend:
    """One DWN serving datapath.  Subclass + :func:`register_backend`.

    ``make_step(model)`` returns ``fn(x) -> (counts, pred)`` for a feature
    batch ``x (B, F)`` on the model's device.
    """

    name: str = "?"
    is_oracle: bool = False

    def make_step(self, model: DWNModelBundle) -> Callable:
        raise NotImplementedError


_REGISTRY: dict[str, Backend] = {}


def register_backend(cls):
    """Class decorator: register a Backend subclass under ``cls.name``."""
    if cls.name in _REGISTRY:
        raise ValueError(f"backend {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown serving backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


@register_backend
class FusedPackedBackend(Backend):
    """The fused CUDA kernels, bits in shared memory end to end.

    The kernel variant and samples per block come from the model's
    ``tuned_configs`` for the step's batch bucket, else from
    ``autotune.DEFAULT_CONFIG``; each config's operands are prepared once
    and reused.
    """

    name = "fused-packed"

    def make_step(self, model: DWNModelBundle) -> Callable:
        fwd_cache: dict = {}

        def fwd_for(config):
            if config not in fwd_cache:
                fwd_cache[config] = fused_ops.make_forward_packed(
                    model.thresholds, model.mappings, model.tables,
                    model.num_classes, config=config)
            return fwd_cache[config]

        # PEN models quantize inputs to the (1, n) grid before the
        # comparator bank (apply_hard semantics)
        frac = model.frozen.input_frac_bits

        def fn(x: torch.Tensor):
            fwd = fwd_for(model.tuned_configs.get(x.shape[0]))
            if frac is not None:
                x = quantize_fixed_point(x, frac)
            return fwd(x)
        return fn


@register_backend
class PackedEagerBackend(Backend):
    """Packed words through plain tensor ops (no custom kernel)."""

    name = "packed-eager"

    def make_step(self, model: DWNModelBundle) -> Callable:
        frozen = model.frozen

        def fn(x: torch.Tensor):
            counts = apply_hard_packed(frozen, x)
            return counts, predict(counts)
        return fn


@register_backend
class FloatOracleBackend(Backend):
    """``apply_hard``: the float bit-exactness oracle."""

    name = "float-oracle"
    is_oracle = True

    def make_step(self, model: DWNModelBundle) -> Callable:
        frozen = model.frozen

        def fn(x: torch.Tensor):
            counts = apply_hard(frozen, x)
            return counts, predict(counts)
        return fn


class BoundBackend:
    """A backend bound to one model: ``bound(x) -> (counts, pred)``."""

    def __init__(self, backend: Backend, model: DWNModelBundle):
        self.backend = backend
        self.model = model
        self._fn = backend.make_step(model)

    @property
    def name(self) -> str:
        return self.backend.name

    @property
    def is_oracle(self) -> bool:
        return self.backend.is_oracle

    def __call__(self, x: torch.Tensor):
        return self._fn(x)


def verify_backends(model: DWNModelBundle,
                    backends: Sequence[BoundBackend],
                    x_probe: np.ndarray) -> dict[str, bool]:
    """Bit-exactness gate: every non-oracle backend vs the float oracle.

    Runs each backend on the same probe rows on the model's device and
    compares counts *and* predictions exactly.  Raises ``RuntimeError`` on
    any divergence — refusing to serve a broken datapath — and returns
    {name: True} for the checked backends otherwise.
    """
    x = torch.from_numpy(np.ascontiguousarray(x_probe, np.float32)).to(
        model.device)
    oracle_bound = next((b for b in backends if b.is_oracle),
                        BoundBackend(get_backend("float-oracle"), model))
    counts_ref, pred_ref = (t.cpu().numpy() for t in oracle_bound(x))
    results: dict[str, bool] = {}
    for b in backends:
        if b.is_oracle:
            continue
        counts, pred = (t.cpu().numpy() for t in b(x))
        ok = (np.array_equal(counts.astype(np.float32),
                             counts_ref.astype(np.float32))
              and np.array_equal(pred, pred_ref))
        if not ok:
            raise RuntimeError(
                f"serving backend {b.name!r} diverged from the apply_hard "
                f"oracle on {model.arch_name!r}; refusing to serve a "
                f"broken datapath")
        results[b.name] = True
    return results


__all__ = [
    "Backend", "BoundBackend", "DWNModelBundle", "available_backends",
    "get_backend", "register_backend", "verify_backends",
]
