"""Roofline terms of one step of the model zoo, counted on the ``meta``
device: the PyTorch counterpart of the reference's
``repro.roofline.analyze``.

The reference compiles each step with XLA and reads the optimized HLO
(``roofline/hlo_costs.py``).  The port lowers no HLO; it runs the step
itself on ``meta`` tensors (shapes only, nothing allocated) and counts:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the step:
  matrix products only, as ``hlo_costs`` counts only ``dot``s.
* **HBM bytes**: every aten op reads each tensor operand and writes its
  result once; views (and allocations, which write nothing) cost nothing
  (``hlo_costs``' rule that structural ops are free).
* **Loops** count their trip counts, because the meta run executes them
  (what ``hlo_costs`` gets from ``known_trip_count``).
* **Per chip**: the global count divided by the chips (``"split":
  "even"``).  The reference's per-device HLO also counts work that
  every chip repeats, so this is a lower bound of its figure.
* **Collectives** (:func:`collective_account`): what the port's step
  over a ``DeviceMesh`` (``models.parallel``, ``sharding.collectives``)
  runs for the partitioner's specs, each term citing the reference's
  layout line it prices, with the reference's ring wire model.
  ``tests/test_torch_lm_mesh.py`` holds ``CommDebugMode``'s counts of a
  prefill and a train step on a (2, 2) gloo mesh to it, kind by kind.

Terms (seconds, per chip; the H100's constants from ``launch.mesh``):

    compute    = flops_per_chip / 989e12
    memory     = hbm_bytes_per_chip / 3.35e12
    collective = sum over links of wire_bytes / the link's rate

A collective whose group stays inside one 8-GPU node moves at NVLink's
450 GB/s; one whose group leaves it (every group wider than 8, and any
group over the "pod" axis) at ``INTERNODE_BW`` (400 Gb/s a GPU).
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..launch.mesh import (GPUS_PER_NODE, HBM_BW, INTERNODE_BW, NVLINK_BW,
                           PEAK_FLOPS_BF16)
from ..models import api
from ..sharding.partition import LogicalAxes, axis_names, axis_size

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: torch dtypes by the reference's (HLO) names
TORCH_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

#: the links a collective's bytes cross, and their rates per card
LINK_BW = {"nvlink": NVLINK_BW, "internode": INTERNODE_BW}


def dtype_bytes(dtype: torch.dtype) -> int:
    return DTYPE_BYTES[TORCH_DTYPE_NAMES[dtype]]


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * dtype_bytes(t.dtype)


def wire_bytes(kind: str, payload: float, n: int) -> float:
    """Wire bytes a device moves in one collective of group size ``n``
    whose per-device payload is ``payload`` (the result's bytes; for a
    reduce-scatter the scattered shard), for bidirectional rings as the
    reference prices them (``roofline/analyze.py:116-124``)."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2 * frac * payload
    if kind == "collective-permute":
        return float(payload)
    if kind == "reduce-scatter":
        return frac * payload * n
    if kind in ("all-gather", "all-to-all"):
        return frac * payload
    raise ValueError(f"no wire model for {kind!r}; kinds: {COLLECTIVES}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    payload_bytes: dict                 # per-device payload per op kind
    wire_bytes: float                   # ring-effective wire bytes/device
    wire_by_link: dict = dataclasses.field(default_factory=dict)
    terms: list = dataclasses.field(default_factory=list)

    def total_payload(self) -> float:
        return float(sum(self.payload_bytes.values()))


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_by_link: dict            # {"nvlink" | "internode": bytes}
    chips: int

    def seconds(self) -> dict:
        t_c = self.flops_per_chip / PEAK_FLOPS_BF16
        t_m = self.hbm_bytes_per_chip / HBM_BW
        t_x = sum(b / LINK_BW[link]
                  for link, b in self.wire_bytes_by_link.items())
        dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
        return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
                "bound": dom[1],
                "step_s_lower_bound": max(t_c, t_m, t_x)}


# ---------------------------------------------------------------------------
# counting a step on the meta device
# ---------------------------------------------------------------------------

#: aten ops that move no bytes although they are not views: reshapes
#: that alias (``_unsafe_view``) and allocations, which write nothing
_FREE_OPS = {"_unsafe_view", "empty", "empty_strided", "empty_like",
             "new_empty", "new_empty_strided", "lift_fresh", "detach",
             "alias"}


def _free(func) -> bool:
    if getattr(func, "is_view", False):
        return True
    return func.__name__.split(".")[0] in _FREE_OPS


class _Traffic(TorchDispatchMode):
    """Adds, for every aten op but a view, the bytes of its tensor
    operands and of its results."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if not _free(func):
            self.bytes += sum(tensor_bytes(t) for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


@dataclasses.dataclass
class StepCounts:
    flops: float
    hbm_bytes: float
    ops: int
    seconds: float


def count_step(fn, *args, **kwargs):
    """Run ``fn`` (on meta tensors) under the FLOP counter and the byte
    counter -> (its result, :class:`StepCounts` of the whole step)."""
    from torch.utils.flop_counter import FlopCounterMode
    traffic = _Traffic()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, traffic:
        out = fn(*args, **kwargs)
    return out, StepCounts(float(flops.get_total_flops()),
                           float(traffic.bytes), traffic.ops,
                           time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# shards on a mesh
# ---------------------------------------------------------------------------

def pairs(tree, other, path=()):
    """(path, leaf of ``tree``, the entry of ``other`` at the same place)
    over two parallel trees of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k in tree:
            yield from pairs(tree[k], other[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, (a, b) in enumerate(zip(tree, other)):
            yield from pairs(a, b, path + (i,))
    else:
        yield path, tree, other


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_shards(mesh, spec) -> list[int]:
    """Devices each dim of a tensor is split over under ``spec``."""
    return [math.prod(axis_size(mesh, a) for a in _spec_axes(e))
            for e in spec]


def shard_bytes(tree, shardings) -> int:
    """Bytes one device holds of a tree of tensors (meta or not) laid out
    by the parallel tree of ``NamedSharding``s; an int leaf (an LM
    cache's position) holds nothing on the device."""
    total = 0
    for _, t, sh in pairs(tree, shardings):
        if not isinstance(t, torch.Tensor):
            continue
        total += tensor_bytes(t) // math.prod(spec_shards(sh.mesh, sh.spec))
    return total


def link_of(mesh, axes) -> str:
    """"nvlink" when every group over the mesh ``axes`` lies inside one
    node of ``GPUS_PER_NODE`` cards (devices numbered row-major over the
    mesh's axes), else "internode"."""
    names = axis_names(mesh)
    span = 0
    for a in axes:
        stride = math.prod(axis_size(mesh, b)
                           for b in names[names.index(a) + 1:])
        span += (axis_size(mesh, a) - 1) * stride
    return "nvlink" if span < GPUS_PER_NODE else "internode"


# ---------------------------------------------------------------------------
# the collective account
# ---------------------------------------------------------------------------

DATA_AXES = ("pod", "data")

#: the reference's lines each term prices
CITE = {
    "loss": "src/repro/models/layers.py:664-668, :714-733 (the aux loss's "
            "and the loss's means over the global batch, split over dp)",
    "norm": "src/repro/optim/grad.py:17-19 (the global norm over every "
            "leaf, sharded alike)",
    "fsdp": "src/repro/sharding/partition.py:39 (embed -> fsdp)",
    "tp": "src/repro/sharding/partition.py:41-50 (heads, ff, ssm heads, "
          "conv_dim, lru -> model)",
    "ssm": "src/repro/models/mamba2.py:78-79, :226-251 (conv_w, conv_b "
           "over conv_dim; out_norm over the model-split d_inner)",
    "lru": "src/repro/models/rglru.py:87-90, :231-240 (wa, wx: the whole "
           "width in, lru out; the gates read every channel)",
    "cross": "src/repro/models/whisper.py:172-194 (the cross K/V of the "
             "encoder states, heads over model)",
    "vocab": "src/repro/sharding/partition.py:38 (vocab -> model)",
    "grads": "src/repro/launch/dryrun.py:131-134 (params in and out "
             "sharded alike)",
    "logits": "src/repro/launch/dryrun.py:146-149, :160-164 (logits "
              "out_shardings None unless logits_sharded)",
    "dwn": "src/repro/models/dwn_arch.py:70, :136 (tables and LUT outputs "
           "over ff -> model: class counts partial)",
}


def _tokens_per_row(cfg, shape, path) -> int:
    """Positions a batch row carries through the params at ``path``."""
    if shape.kind == "decode":
        return 1
    if cfg.family == "encdec" and path[0] == "enc_layers":
        return cfg.enc_frames
    if cfg.family == "vlm" and path[0] == "layers":
        return shape.seq_len + cfg.num_patches
    return shape.seq_len


def _in_block(path) -> bool:
    """Whether the params at ``path`` belong to a layer, which remat
    recomputes in the backward (``layers.run_block``): a list of layers,
    or recurrentgemma's superblocks and tail."""
    return str(path[0]).endswith("layers") or path[0] in ("super", "tail")


def _unused(cfg, shape, path) -> bool:
    """Params a step never reads: the encoder's in a decode step (the
    cross K/V come from the cache)."""
    return (cfg.family == "encdec" and shape.kind == "decode"
            and path[0] in ("enc_layers", "enc_ln"))


def collective_account(cfg, shape, params, shardings, axes, *,
                       rows_local: int, num_micro: int = 1,
                       logits_sharded: bool = False) -> CollectiveStats:
    """The collectives one step needs on the mesh of ``shardings`` (the
    params' ``NamedSharding``s; ``axes`` their logical axes), per device.

    ``rows_local``: batch rows a device holds of one microbatch (of the
    whole batch when ``num_micro`` is 1).  Terms:

    * a param split over a data axis (FSDP): an all-gather of it over
      those axes once a step (the step gathers its params and keeps them
      for every microbatch's forward and backward), and in training one
      reduce-scatter of its float32 gradient a step;
    * a param replicated over the data axes (with more than one data
      shard): in training one all-reduce of its gradient over them;
    * a param the model axis leaves whole whose gradient each model rank
      holds in part (the attention's K/V projections and qk-norms, which
      a rank applies to its own heads only): in training one all-reduce
      of its gradient over the model axis;
    * the Megatron pair: every output projection (a param whose last
      logical axis is "embed" and whose other dims the model axis splits)
      all-reduces the (rows_local, positions, d_model) activations it
      makes over the model axis (bf16; the experts' combine float32),
      each forward, again in training where remat recomputes its layer
      (``cfg.remat``), and once in each backward (the f at its block's
      input); the experts' gates all-reduce their float32 gradient in
      each backward; a vocab-split embedding all-reduces its lookup in
      the forward, and in training the unembedding (or the tied table)
      all-reduces its input's gradient in the backward;
    * the logits, vocab-split, all-gathered over the model axis: the last
      ones unless ``logits_sharded``, and in training every position's
      for the loss each microbatch; the last ones' batch gathered over
      the data axes (the reference's ``out_shardings`` replicate them);
      the DWN's class counts, partial over LUTs split on the model axis,
      all-reduced there, then gathered over the data axes;
    * in training, with the batch split over the data axes, the loss's
      sum and count all-reduced over them each microbatch, and each MoE
      layer's two aux-loss means (each forward, its recomputation
      included); the gradient norm's sum of squares all-reduced over
      each mesh axis once a step;
    * where the model ranks each run a share of a block's channels
      (:func:`_channel_terms`): mamba2's ``out_norm`` over the model-split
      ``d_inner`` (its float32 sums of squares all-reduced forward and
      backward) and the convolution's taps and bias gathered over the
      model axis each forward (a reduce-scatter of their gradient in each
      backward); the RG-LRU gates' gather of the convolution's
      model-split output (likewise); whisper's encoder states entering
      the cross K/V projections through one f (its gradient all-reduced
      in each backward).

    The model-partial gradients are the family module's
    ``partial_grad``'s (``api.partial_grad``).
    """
    train = shape.kind == "train"
    stats = CollectiveStats({}, {}, 0.0, {})
    mesh = next(pairs(params, shardings))[2].mesh
    names = axis_names(mesh)
    dp = tuple(a for a in DATA_AXES if a in names)
    vocab_split = False

    def add(kind, what, group, count, payload, cite):
        if count <= 0 or not group:
            return
        n = math.prod(axis_size(mesh, a) for a in group)
        if n <= 1:
            return
        link = link_of(mesh, group)
        wire = count * wire_bytes(kind, payload, n)
        stats.counts[kind] = stats.counts.get(kind, 0) + count
        stats.payload_bytes[kind] = (stats.payload_bytes.get(kind, 0)
                                     + count * payload)
        stats.wire_bytes += wire
        stats.wire_by_link[link] = stats.wire_by_link.get(link, 0.0) + wire
        stats.terms.append({"kind": kind, "what": what, "group": list(group),
                            "n": n, "link": link, "count": count,
                            "payload_bytes": payload, "wire_bytes": wire,
                            "cites": CITE[cite]})

    act = 2 * cfg.d_model                     # one bf16 activation row
    uses_fwd = num_micro if train else 1
    recompute = 2 if (train and cfg.remat) else 1
    n_dp = math.prod(axis_size(mesh, a) for a in dp)
    tp = axis_size(mesh, "model") if "model" in names else 1
    partial_grad = api.partial_grad(cfg, tp)
    for path, t, sh in pairs(params, shardings):
        ax = _leaf_axes(axes, path)
        if _unused(cfg, shape, path):
            continue
        shards = spec_shards(mesh, sh.spec)
        on = [_spec_axes(e) for e in sh.spec]
        data = tuple(a for dim in on for a in dim if a in DATA_AXES)
        model_dims = [d for d, dim in enumerate(on) if "model" in dim]
        n_model = math.prod(shards[d] for d in model_dims)
        name = ".".join(str(p) for p in path)
        full = tensor_bytes(t)
        if data:
            gathered = full // n_model
            add("all-gather", f"{name}: FSDP gather a step", data, 1,
                gathered, "fsdp")
            if train:
                add("reduce-scatter", f"{name}: gradient", data, 1,
                    4 * t.numel() // math.prod(shards), "grads")
        elif train and dp:
            add("all-reduce", f"{name}: gradient", dp, 1,
                4 * t.numel() // n_model, "grads")
        rows = rows_local * _tokens_per_row(cfg, shape, path)
        if (train and not model_dims and "model" in names
                and partial_grad(path)):
            add("all-reduce", f"{name}: gradient, partial a model rank",
                ("model",), 1, 4 * t.numel() // math.prod(shards), "grads")
        if path[-1] == "router" and cfg.family == "moe":
            if train and n_dp > 1:
                add("all-reduce", f"{name}: the aux loss's means",
                    dp, num_micro * recompute, 2 * 4 * t.shape[-1], "loss")
        if not model_dims:
            continue
        fwd = uses_fwd * (recompute if _in_block(path) else 1)
        _channel_terms(cfg, path, t, add, rows=rows, fwd=fwd,
                       bwd=num_micro if train else 0, tp=tp)
        moe = len(path) > 1 and path[-2] == "moe"
        if path[:2] == ("embed", "table"):
            vocab_split = True
            add("all-reduce", f"{name}: vocab-split lookup", ("model",),
                uses_fwd, rows * act, "vocab")
            if train and (cfg.tie_embeddings or cfg.family == "encdec"):
                add("all-reduce", f"{name}: tied unembedding's input "
                    f"gradient", ("model",), num_micro, rows * act, "vocab")
        elif path[:2] == ("unembed", "w"):
            vocab_split = True
            if train:
                add("all-reduce", f"{name}: unembedding's input gradient",
                    ("model",), num_micro, rows * act, "vocab")
        elif tuple(ax) and ax[-1] == "embed" and model_dims[-1] < len(on) - 1:
            out = 2 * act if moe else act          # the experts' float32
            add("all-reduce", f"{name}: output projection (forward)",
                ("model",), fwd, rows * out, "tp")
            if train:
                add("all-reduce", f"{name}: output projection (backward)",
                    ("model",), num_micro, rows * act, "tp")
            if train and moe:
                add("all-reduce", f"{name}: the gates' gradient",
                    ("model",), num_micro, rows * cfg.top_k * 4, "tp")
        elif cfg.family == "dwn" and path == ("tables",):
            counts = rows_local * cfg.vocab_size * 4
            add("all-reduce", "tables: partial class counts", ("model",),
                uses_fwd, counts, "dwn")
    if train:
        if cfg.family == "encdec" and tp > 1:
            add("all-reduce", "encoder states' gradient at the cross K/V "
                "projections' f", ("model",), num_micro,
                rows_local * cfg.enc_frames * act, "cross")
        if vocab_split:
            rows = rows_local * _tokens_per_row(cfg, shape, ("layers",))
            add("all-gather", "logits over the vocabulary, for the loss",
                ("model",), num_micro,
                rows * 2 * cfg.vocab_padded(tp), "logits")
        if n_dp > 1:
            add("all-reduce", "the loss's sum and count", dp, num_micro, 8,
                "loss")
        for a in names:
            add("all-reduce", f"gradient norm over {a}", (a,), 1, 4, "norm")
    else:
        if cfg.family == "dwn":
            per_row, split = 4 * cfg.vocab_size, False
        else:
            per_row = 2 * cfg.vocab_padded(tp)
            split = vocab_split
            if split and not logits_sharded:
                add("all-gather", "logits over the vocabulary", ("model",),
                    1, rows_local * per_row, "logits")
        if rows_local * n_dp == shape.global_batch * (
                shape.seq_len if cfg.family == "dwn" else 1):
            keep = tp if (split and logits_sharded) else 1
            add("all-gather", "logits over the batch", dp, 1,
                rows_local * n_dp * per_row // keep, "logits")
    return stats


def _channel_terms(cfg, path, t, add, *, rows: int, fwd: int, bwd: int,
                   tp: int) -> None:
    """The collectives of a model-split leaf of the SSM or hybrid block
    (``rows`` positions a device holds; ``fwd`` forwards, ``bwd``
    backwards a step; see :func:`collective_account`)."""
    if cfg.family == "ssm" and path[-1] == "conv_w":
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        split = heads % tp == 0
        name = ".".join(str(p) for p in path[:-1])
        add("all-gather", f"{name}: the convolution's taps and bias",
            ("model",), fwd, (t.shape[0] + 1) * t.shape[1] * 4, "ssm")
        if split:
            add("reduce-scatter", f"{name}: the convolution's taps' and "
                f"bias' gradient", ("model",), bwd,
                (t.shape[0] + 1) * t.shape[1] * 4, "ssm")
    elif cfg.family == "ssm" and path[-2:] == ("out_norm", "scale"):
        name = ".".join(str(p) for p in path)
        add("all-reduce", f"{name}: sum of squares over the split d_inner",
            ("model",), fwd + bwd, rows * 4, "ssm")
    elif cfg.family == "hybrid" and path[-1] == "conv_w":
        name = ".".join(str(p) for p in path[:-1])
        add("all-gather", f"{name}: the RG-LRU gates' float32 input",
            ("model",), fwd, rows * 4 * cfg.lru_width, "lru")
        add("reduce-scatter", f"{name}: the RG-LRU gates' input gradient",
            ("model",), bwd, rows * 4 * cfg.lru_width, "lru")


def _leaf_axes(axes, path):
    node = axes
    for k in path:
        node = node[k]
    if not isinstance(node, LogicalAxes):
        raise TypeError(f"{path}: no logical axes")
    return node


def model_flops(cfg, shape, *, include_backward: bool) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); forward = 2*N*D
    (the reference's formula)."""
    n = cfg.num_active_params() if cfg.family == "moe" else cfg.num_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens


__all__ = ["COLLECTIVES", "CollectiveStats", "DTYPE_BYTES", "LINK_BW",
           "RooflineTerms", "StepCounts", "TORCH_DTYPE_NAMES",
           "collective_account", "count_step", "dtype_bytes", "link_of",
           "model_flops", "pairs", "shard_bytes", "spec_shards",
           "tensor_bytes", "wire_bytes"]
