"""Model-zoo API of the port: family dispatch and the step factories the
serving engine and the train CLI call (the reference's
``repro.models.api``).

    make_optimizer(lr)                -> Adam (the reference's LM AdamW)
    make_train_step(cfg, *, tp, num_micro, opt, clip_norm, mesh)
                                      -> (step(params, opt, batch), opt)
    make_prefill(cfg, *, tp, cache_len, mesh) -> fn(params, batch)
    make_decode_step(cfg, *, tp, mesh) -> fn(params, cache, batch)
    shard_params(cfg, params, mesh)   -> the params as DTensors
    param_shardings(cfg, params, mesh) -> their ``NamedSharding``s
    abstract_params(cfg, tp)          -> the params on the ``meta`` device
    param_axes(cfg)                   -> their logical axes
    batch_specs(cfg, shape, micro=)   -> one step's batch on ``meta``
    batch_axes(cfg, shape, micro=)    -> its logical axes
    abstract_cache(cfg, shape, tp)    -> the cache on ``meta``
    cache_axes(cfg, shape)            -> its logical axes

Families: dense, MoE and VLM (``transformer``), SSM (``mamba2``), hybrid
(``rglru``), encoder-decoder (``whisper``) and the paper's DWN
(``dwn_arch``).  An LM batch carries ``tokens`` and ``labels``, plus
``patches`` (VLM) or ``frames`` (encoder-decoder); a DWN batch carries
``features`` (B, F) and ``labels`` (B,).

The abstract trees are the reference's shapes at any tp (a ``meta``
tensor where the reference has a ``ShapeDtypeStruct``; the layers of an
LM are a list where the reference stacks them).  ``tp`` lays out heads,
caches and the vocabulary as the reference's do at that degree (1 by
default here, 16 in the reference).  Without ``mesh`` a step runs that
layout on one device.  With a ``("data", "model")`` ``DeviceMesh``
(``launch.mesh.make_host_mesh``; every LM family) the params are
DTensors (:func:`shard_params`) and each rank runs its shards
(``models.parallel``): tp is the mesh's "model" size, the batch's rows
split over "data", the logits come back whole on every rank, and the
cache holds this rank's rows and its share of the KV heads, the SSM
heads or the RG-LRU channels.  After a training step's backward the
gradients are reduced by ``models.parallel.reduce_grads`` with the
family's ``partial_grad``: the leaves the model axis leaves whole whose
gradient each model rank holds in part.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..optim.adam import Adam, leaves
from ..optim.grad import accumulate_grads, clip_by_global_norm, value_and_grad
from ..sharding import collectives as C
from ..sharding.annotate import use_mesh
from ..sharding.partition import (Partitioner, axis_size, is_device_mesh,
                                  logical)
from . import dwn_arch, mamba2, rglru, transformer, whisper
from . import layers as L
from . import parallel as P

MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "ssm": mamba2, "hybrid": rglru, "encdec": whisper,
           "dwn": dwn_arch}

META = torch.device("meta")

#: the families that run over a ``DeviceMesh``: every LM family
MESH_FAMILIES = transformer.FAMILIES + ("ssm", "hybrid", "encdec")


def module_for(cfg: ArchConfig):
    """The model module of ``cfg.family``; ``NotImplementedError`` for a
    family the port does not have."""
    if cfg.family not in MODULES:
        raise NotImplementedError(
            f"{cfg.name}: no model module for family {cfg.family!r}; the "
            f"port runs {sorted(MODULES)}")
    return MODULES[cfg.family]


# ---------------------------------------------------------------------------
# abstract params / batches / caches (shapes on the meta device)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig, tp: int = 16):
    """The params of ``cfg`` laid out at ``tp`` on the ``meta`` device:
    shapes and dtypes, nothing allocated or drawn (the float32 training
    form)."""
    if cfg.family == "dwn":
        return dwn_arch.init_params(torch.Generator(), cfg, tp, device=META)
    return module_for(cfg).init_params(cfg, tp=tp, device=META,
                                       dtype=torch.float32)


def param_axes(cfg: ArchConfig):
    return module_for(cfg).param_axes(cfg)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                micro: bool = False) -> dict:
    """One step's data batch as ``meta`` tensors.

    For train shapes with gradient accumulation, ``micro=True`` prepends
    the (num_micro, batch/num_micro, ...) microbatch axes.
    """
    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=META)

    B, S = shape.global_batch, shape.seq_len
    lead: tuple = (B,)
    if micro and shape.num_microbatches > 1:
        m = shape.num_microbatches
        if B % m:
            raise ValueError(f"{B} sequences do not split into {m} "
                             f"microbatches")
        lead = (m, B // m)
    i32 = torch.int32
    if cfg.family == "dwn":
        # samples = global_batch x seq_len (feature vectors, not tokens)
        n = shape.global_batch * shape.seq_len
        rows = (n,)
        if micro and shape.num_microbatches > 1:
            m = shape.num_microbatches
            rows = (m, n // m)
        batch = {"features": spec(rows + (cfg.d_model,), torch.float32)}
        if shape.kind == "train":
            batch["labels"] = spec(rows, i32)
        return batch
    if shape.kind == "decode":
        return {"tokens": spec(lead + (1,), i32)}
    batch = {"tokens": spec(lead + (S,), i32)}
    if shape.kind == "train":
        batch["labels"] = spec(lead + (S,), i32)
    if cfg.family == "encdec":
        batch["frames"] = spec(lead + (cfg.enc_frames, cfg.d_model),
                               L.COMPUTE_DTYPE)
    if cfg.family == "vlm":
        batch["patches"] = spec(lead + (cfg.num_patches, cfg.d_model),
                                L.COMPUTE_DTYPE)
    return batch


def batch_axes(cfg: ArchConfig, shape: ShapeConfig, *, micro: bool = False):
    """Logical axes of the batch (``sharding.partition.DEFAULT_RULES``)."""
    lead = ("micro", "batch") if (micro and shape.num_microbatches > 1) \
        else ("batch",)
    if cfg.family == "dwn":
        ax = {"features": logical(*lead, None, name="batch.features")}
        if shape.kind == "train":
            ax["labels"] = logical(*lead, name="batch.labels")
        return ax
    seq = "seq_sp" if shape.global_batch == 1 else None   # SP for B=1
    ax = {"tokens": logical(*lead, None if shape.kind == "decode" else seq,
                            name="batch.tokens")}
    if shape.kind == "train":
        ax["labels"] = logical(*lead, seq, name="batch.labels")
    if cfg.family == "encdec" and shape.kind != "decode":
        ax["frames"] = logical(*lead, None, None, name="batch.frames")
    if cfg.family == "vlm" and shape.kind != "decode":
        ax["patches"] = logical(*lead, None, None, name="batch.patches")
    return ax


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig, tp: int = 16):
    """The cache of ``shape`` laid out at ``tp`` on the ``meta`` device
    (``pos`` is the int an LM cache starts from, a 0-d int32 tensor for
    the DWN)."""
    return module_for(cfg).init_cache(cfg, shape.global_batch,
                                      shape.seq_len, tp=tp, device=META)


def cache_axes(cfg: ArchConfig, shape: ShapeConfig):
    seq_shard = shape.global_batch == 1          # SP for long-context B=1
    return module_for(cfg).cache_axes(cfg, seq_shard=seq_shard)


# ---------------------------------------------------------------------------
# params over a DeviceMesh
# ---------------------------------------------------------------------------

def param_shardings(cfg: ArchConfig, params, mesh):
    """The ``NamedSharding`` of every leaf of ``params`` (whole tensors:
    the init at the mesh's tp) on ``mesh`` by ``param_axes`` and the
    partitioner, its divisibility fallbacks included."""
    return Partitioner(mesh).tree_shardings(params, param_axes(cfg))


def shard_params(cfg: ArchConfig, params, mesh):
    """``params`` (the same whole tensors on every rank) as DTensors laid
    out on the ``DeviceMesh`` ``mesh`` (each rank keeps its chunk)."""
    return P.shard_tree(params, param_shardings(cfg, params, mesh))


def partial_grad(cfg: ArchConfig, tp: int):
    """The predicate ``models.parallel.reduce_grads`` reads: whether the
    leaf at a path is one whose gradient each of ``tp`` model ranks
    holds only in part (the family module's ``partial_grad``)."""
    fn = getattr(module_for(cfg), "partial_grad", None)
    return (lambda path: False) if fn is None else (
        lambda path: fn(path, cfg, tp))


def _on_mesh(cfg: ArchConfig, mesh, tp: int):
    """``mesh`` if it is a ``DeviceMesh`` (else None), checked against the
    family and the layout's tp."""
    if not is_device_mesh(mesh):
        return None
    if cfg.family not in MESH_FAMILIES:
        raise ValueError(
            f"{cfg.name}: the {cfg.family!r} family runs data-parallel "
            f"through ServingEngine(data_parallel=True) and "
            f"train_dwn_batch(data_parallel=True); the steps here run the "
            f"LM families {MESH_FAMILIES} over a DeviceMesh")
    model = axis_size(mesh, "model")
    if tp != model:
        raise ValueError(f"params laid out at tp {tp} on a mesh whose "
                         f"'model' axis has {model} ranks")
    return mesh


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_optimizer(lr: float = 3e-4) -> Adam:
    return Adam(lr=lr, b1=0.9, b2=0.95, weight_decay=0.1)


def make_train_step(cfg: ArchConfig, *, tp: int = 1, num_micro: int = 1,
                    opt: Adam | None = None, clip_norm: float = 1.0,
                    mesh=None):
    """Returns ``(step, opt)``; ``step(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm"})`` with the reference's arithmetic:
    the loss and its gradients (with ``num_micro > 1`` the batch leaves
    carry a leading (num_micro, micro_b) pair, and the loss and gradients
    are summed microbatch by microbatch in a loop and scaled by
    ``1 / num_micro``), clipped to ``clip_norm`` by their global norm, then
    one Adam step.  The model runs at ``tp`` (its params laid out so).

    ``params`` must be the float32 training form
    (``init_params(..., dtype=torch.float32)``); they and ``opt_state``
    are updated in place and returned.  ``loss`` and ``grad_norm`` are
    float32 tensors on the params' device.

    On a ``DeviceMesh`` ``mesh`` the params are DTensors
    (:func:`shard_params`) and the moments ``opt.init`` makes of them
    take their placements.  Each rank gathers its model rank's params
    over "data" once a step, runs its rows of the batch (the rows must
    split over "data"), the loss a mean over every rank's rows, then
    ``models.parallel.reduce_grads`` and the clip by the norm over every
    shard; every rank returns the same loss and norm.
    """
    mod = module_for(cfg)
    opt = opt or make_optimizer()
    mesh = _on_mesh(cfg, mesh, tp)

    def loss_of(params, data):
        return mod.loss_fn(params, cfg, data, tp=tp), None

    def grads_of(params, batch):
        if num_micro == 1:
            (loss, _), grads = value_and_grad(loss_of, params, batch)
        else:
            loss, grads = accumulate_grads(loss_of, params, batch, num_micro)
        return loss, grads

    def step(params, opt_state, batch):
        bad = sorted({str(t.dtype) for t in leaves(params)
                      if t.dtype != torch.float32})
        if bad:
            raise ValueError(
                f"{cfg.name}: training needs float32 params (the master "
                f"weights; got {bad}): init_params(..., "
                f"dtype=torch.float32)")
        if mesh is None:
            loss, grads = grads_of(params, batch)
        else:
            with use_mesh(mesh):
                rows, _ = P.split_rows(batch, mesh, required=True,
                                       dim=0 if num_micro == 1 else 1)
                with C.batch_split():
                    loss, grads = grads_of(P.gather_params(params), rows)
                grads = P.reduce_grads(grads, params,
                                       partial_grad(cfg, tp))
        with torch.profiler.record_function("lm.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                               in_place=True)
        with torch.profiler.record_function("lm.adam"):
            opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step, opt


def make_prefill(cfg: ArchConfig, *, tp: int = 1,
                 cache_len: int | None = None, mesh=None):
    """``fn(params, batch) -> (last logits (B, Vp), cache)``; on a
    ``DeviceMesh`` every rank returns the whole batch's logits and its own
    share of the cache."""
    mod = module_for(cfg)
    mesh = _on_mesh(cfg, mesh, tp)

    def fn(params, batch):
        if mesh is None:
            return mod.prefill(params, cfg, batch, tp=tp,
                               cache_len=cache_len)
        with use_mesh(mesh):
            rows, split = P.split_rows(batch, mesh)
            logits, cache = mod.prefill(P.gather_params(params), cfg, rows,
                                        tp=tp, cache_len=cache_len)
            return P.gather_rows(logits, split), cache

    return fn


def make_decode_step(cfg: ArchConfig, *, tp: int = 1, mesh=None):
    """``fn(params, cache, batch) -> (logits (B, Vp), cache)``; on a
    ``DeviceMesh`` the cache is this rank's (from the mesh's prefill)."""
    mod = module_for(cfg)
    mesh = _on_mesh(cfg, mesh, tp)

    def fn(params, cache, batch):
        if mesh is None:
            return mod.decode_step(params, cfg, cache, batch["tokens"],
                                   tp=tp)
        with use_mesh(mesh):
            rows, split = P.split_rows({"tokens": batch["tokens"]}, mesh)
            logits, cache = mod.decode_step(P.gather_params(params), cfg,
                                            cache, rows["tokens"], tp=tp)
            return P.gather_rows(logits, split), cache

    return fn


__all__ = ["MESH_FAMILIES", "MODULES", "abstract_cache", "abstract_params",
           "batch_axes", "batch_specs", "cache_axes", "make_decode_step",
           "make_optimizer", "make_prefill", "make_train_step", "module_for",
           "param_axes", "param_shardings", "partial_grad", "shard_params"]
