"""LM-backbone feature workload (``lm-head``): the DWN head on qwen3-8b.

The port's counterpart of the reference's ``repro.workloads.lm_head``.  A
reduced qwen3-8b backbone (fixed init, frozen) pools its final logits
into 16 features per sequence; labels come from a fixed teacher
projection of those features, so the task isolates what a DWN head can
learn on top of frozen backbone features.  The loader materialises a
seeded (tokens -> features -> labels) split that the DWN trainer takes
like any other 16-feature 5-class dataset.

:func:`pool_features` is the feature stage: the serving engine's
``dwn_head`` path applies the same pooling to its own backbone's logits,
so a head trained here serves on the features it was trained on.  Only
the first :data:`FEATS` vocabulary columns are pooled, so both unembed
only those (:func:`head_features`): the same dot products as the full
unembedding's first columns.

Differences by design: the backbone's init and the teacher ``Wt`` come
from ``torch.Generator``s seeded 0 and 7 on the host, since
``jax.random`` cannot be reproduced without JAX, so the port's split is
its own; :func:`make_backbone` takes the reference's params and teacher
to compute the reference's.  The backbone runs on ``device`` (default
the card), so a split made on the card and one made on the CPU differ by
the rounding of their bf16 products; splits are cached per device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.model import DWNConfig
from ..data.jsc import JSCData
from ..device import resolve_device
from .base import Workload, register_workload

FEATS = 16
NUM_CLASSES = 5
SEQ_LEN = 32
BACKBONE = "qwen3-8b"

LM_HEAD_PRESETS = {
    "lm-head-50": DWNConfig(num_features=FEATS, bits_per_feature=64,
                            encoding="uniform", lut_counts=(50,),
                            num_classes=NUM_CLASSES),
}


def pool_features(logits: torch.Tensor) -> torch.Tensor:
    """Pool full-sequence backbone logits (B, S, >= FEATS) into FEATS head
    features: ``tanh(0.3 * mean-over-sequence logits[:, :FEATS])``, the
    mean taken in float32 and rounded to the logits' dtype (bf16), then
    float32, as the reference's ``jnp.mean`` of bf16 logits rounds."""
    cols = logits[..., :FEATS]
    pooled = cols.float().mean(dim=1).to(logits.dtype).float()
    return torch.tanh(pooled * 0.3)


def head_features(params, cfg, tokens) -> torch.Tensor:
    """Backbone forward over ``tokens`` (B, S) -> pooled features (B,
    FEATS) float32, unembedding only the FEATS columns pooled."""
    from ..models import api
    logits, _, _ = api.module_for(cfg).forward(
        params, cfg, {"tokens": tokens}, vocab_cols=FEATS)
    return pool_features(logits)


def make_backbone(device=None, *, params=None, teacher=None) -> dict:
    """The frozen reduced backbone on ``device``: ``{"cfg", "params",
    "Wt", "device"}``.  By default the port's own init (a host generator
    seeded 0, so the same weights on every device) and teacher (seeded 7,
    normal times 2); ``params`` (the port's tree, e.g. the reference's
    init through ``params_from_numpy``) and ``teacher`` ((FEATS,
    NUM_CLASSES)) replace them."""
    from ..configs import get_arch
    from ..models import api
    from ..optim.adam import map_tree
    dev = resolve_device(device)
    cfg = get_arch(BACKBONE).reduced()
    if params is None:
        params = api.module_for(cfg).init_params(cfg, seed=0)
    if teacher is None:
        gen = torch.Generator().manual_seed(7)
        teacher = torch.randn((FEATS, NUM_CLASSES), generator=gen) * 2.0
    wt = torch.as_tensor(teacher, dtype=torch.float32)
    return {"cfg": cfg, "device": dev,
            "params": map_tree(lambda t: t.to(dev), params),
            "Wt": wt.to(dev)}


_BACKBONE_CACHE: dict[str, dict] = {}


def _backbone(device=None) -> dict:
    """The default backbone on ``device``, built once per device."""
    dev = resolve_device(device)
    if str(dev) not in _BACKBONE_CACHE:
        _BACKBONE_CACHE[str(dev)] = make_backbone(dev)
    return _BACKBONE_CACHE[str(dev)]


def teacher_labels(feats: torch.Tensor, backbone: dict | None = None
                   ) -> np.ndarray:
    """``argmax(feats @ Wt)`` (the first maximum) as int32 labels."""
    bb = backbone or _backbone(feats.device)
    return (feats @ bb["Wt"]).argmax(-1).cpu().numpy().astype(np.int32)


@torch.no_grad()
def _materialize(n: int, seed: int, chunk: int = 64, *,
                 backbone: dict | None = None, device=None):
    """Seeded tokens -> pooled features -> teacher labels for n
    sequences."""
    bb = backbone or _backbone(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, bb["cfg"].vocab_size,
                        (n, SEQ_LEN)).astype(np.int32)
    xs, ys = [], []
    for i in range(0, n, chunk):
        t = torch.from_numpy(toks[i:i + chunk]).to(bb["device"])
        feats = head_features(bb["params"], bb["cfg"], t)
        xs.append(feats.cpu().numpy().astype(np.float32))
        ys.append(teacher_labels(feats, bb))
    x = np.concatenate(xs)
    # the features are tanh-squashed into (-1, 1), the encoder's input
    # range, so no train-statistics renormalisation (it would move the
    # served features away from the trained ones)
    x = np.clip(x, -1.0, np.nextafter(np.float32(1.0), np.float32(0.0)))
    return x, np.concatenate(ys)


_SPLIT_CACHE: dict[tuple, JSCData] = {}


def load_lm_head(n_train: int = 1024, n_test: int = 512, seed: int = 0, *,
                 device=None) -> JSCData:
    """The seeded split, its features made on ``device`` (default the
    card; raises without one); disjoint token streams per split."""
    key = (n_train, n_test, seed, str(resolve_device(device)))
    if key not in _SPLIT_CACHE:
        x_tr, y_tr = _materialize(n_train, seed * 2 + 1, device=device)
        x_te, y_te = _materialize(n_test, seed * 2 + 2, device=device)
        _SPLIT_CACHE[key] = JSCData(x_tr, y_tr, x_te, y_te)
    return _SPLIT_CACHE[key]


LM_HEAD = register_workload(Workload(
    name="lm-head",
    num_features=FEATS,
    num_classes=NUM_CLASSES,
    loader=lambda n_train, n_test, seed=0, *, device=None: load_lm_head(
        n_train, n_test, seed=seed, device=device),
    presets=LM_HEAD_PRESETS,
    description=("pooled qwen3-8b (reduced) backbone features, 5-class "
                 "teacher-projection labels; promotes "
                 "examples/dwn_head_lm.py to a first-class workload"),
    backbone=BACKBONE,
    cap_train=1024,
    cap_test=512,
))

__all__ = ["BACKBONE", "FEATS", "LM_HEAD", "LM_HEAD_PRESETS", "NUM_CLASSES",
           "SEQ_LEN", "head_features", "load_lm_head", "make_backbone",
           "pool_features", "teacher_labels"]
