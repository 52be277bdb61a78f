"""Logical-axis sharding rules -> partition specs and DTensor placements.

The PyTorch counterpart of the reference's ``repro.sharding.partition``.
Every parameter and activation of the model zoo is annotated with
*logical* axis names ("embed", "q_heads", "ff", ...).  This module maps
logical names onto mesh axes by the production parallelism plan:

    data-parallel + FSDP     ->  ("pod", "data")   (pod only when present)
    tensor parallel          ->  ("model",)
    sequence parallel (SP)   ->  ("data",)  for long-context inference

with a *divisibility fallback*: a tensor dimension that the product of
its mesh axes does not divide is replicated instead, and the event is
recorded (``Partitioner.fallbacks``).

A mesh is either a ``torch.distributed.device_mesh.DeviceMesh`` (ranks
and a process group) or an :class:`AbstractMesh` (axis names and sizes
only: the 256- and 512-card production meshes, which no machine here
has).  A spec is a :class:`PartitionSpec`, one entry a tensor dim: None
(replicated), a mesh axis name, or a tuple of them.  On a
``DeviceMesh``, :meth:`Partitioner.placements` turns a spec into DTensor
placements, one a mesh dim.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Sequence

logger = logging.getLogger(__name__)

#: logical axis -> mesh axis-or-axes (None = replicate); "fsdp" and "dp"
#: resolve to the mesh's data-ish axes
DEFAULT_RULES: dict[str, object] = {
    # parameter axes
    "layers": None,            # scan-stacked layer dim: never sharded
    "vocab": "model",          # embedding/lm-head vocab dim: TP
    "embed": "fsdp",           # d_model dim of params: FSDP (ZeRO-3)
    "embed_r": None,           # d_model dim where FSDP would double-shard
    "q_heads": "model",        # attention query heads: TP
    "kv_heads": "model",       # attention kv heads (padded/repeated): TP
    "head_dim": None,
    "ff": "model",             # MLP hidden: TP
    "experts": None,           # MoE expert dim: FSDP'd via embed dim instead
    "experts_ep": "model",     # MoE EP: experts shard over the model axis
    "ssm_heads": "model",      # mamba2 heads: TP
    "ssm_state": None,
    "conv_dim": "model",
    "lru": "model",            # RG-LRU width: TP
    "norm": None,              # norm scales: replicated
    # activation axes
    "batch": "dp",             # global batch: DP  (pod x data)
    "seq": None,               # sequence: replicated by default
    "seq_sp": "data",          # sequence-parallel shards (long-context)
    "act_embed": None,
    "act_heads": "model",
    "act_ff": "model",
    "act_vocab": "model",
    "kv_seq": None,            # kv-cache seq dim (decode)
    "kv_seq_sp": "data",       # kv-cache seq dim, sequence-sharded
    "dwn_batch": "dp",         # DWN serving batch buckets: data-parallel
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh as axis names and sizes, with no devices behind it.
    ``shape`` maps a name to its size, as the reference's meshes do."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} and {self.sizes} differ "
                             f"in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (ranks behind it), not an
    :class:`AbstractMesh` or None."""
    return hasattr(mesh, "mesh_dim_names")


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    if is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """Devices along the mesh axis ``name``."""
    if is_device_mesh(mesh):
        return mesh.size(axis_names(mesh).index(name))
    return mesh.shape[name]


class PartitionSpec(tuple):
    """One entry a tensor dim: None, a mesh axis name or a tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: PartitionSpec


def _resolve(axis: object, mesh) -> tuple[str, ...]:
    """Resolve a rule value to a tuple of mesh axis names."""
    if axis is None:
        return ()
    names = axis_names(mesh)
    if axis == "fsdp" or axis == "dp":
        # pod composes with data when present.
        return tuple(a for a in ("pod", "data") if a in names)
    if isinstance(axis, (tuple, list)):
        return tuple(a for a in axis if a in names)
    return (axis,) if axis in names else ()


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


@dataclasses.dataclass
class FallbackEvent:
    tensor: str
    dim: int
    logical: str
    wanted: tuple
    size: int
    divisor: int


class Partitioner:
    """Builds partition specs from logical axis annotations for one mesh."""

    def __init__(self, mesh, rules: Mapping[str, object] | None = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.fallbacks: list[FallbackEvent] = []

    def spec(self, logical: Sequence[str | None],
             shape: Sequence[int] | None = None,
             name: str = "?") -> PartitionSpec:
        """The spec of a tensor with the given logical axes.

        If ``shape`` is given, dimensions not divisible by their mesh
        axes degrade to replication (recorded in ``self.fallbacks``).
        """
        parts = []
        used: set[str] = set()
        for d, ax in enumerate(logical):
            if ax is None:
                parts.append(None)
                continue
            phys = _resolve(self.rules.get(ax, None), self.mesh)
            # an axis may appear at most once in a spec
            phys = tuple(a for a in phys if a not in used)
            if not phys:
                parts.append(None)
                continue
            if shape is not None:
                div = _axes_size(self.mesh, phys)
                if div > 1 and shape[d] % div != 0:
                    self.fallbacks.append(FallbackEvent(
                        name, d, ax, phys, shape[d], div))
                    logger.info("sharding fallback: %s dim %d (%s=%d) not "
                                "divisible by %s (=%d); replicating",
                                name, d, ax, shape[d], phys, div)
                    parts.append(None)
                    continue
            used.update(phys)
            parts.append(phys if len(phys) > 1 else phys[0])
        return PartitionSpec(*parts)

    def sharding(self, logical: Sequence[str | None],
                 shape: Sequence[int] | None = None,
                 name: str = "?") -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical, shape, name))

    def placements(self, spec: PartitionSpec) -> tuple:
        """DTensor placements of ``spec`` on this ``DeviceMesh``: one a
        mesh dim, ``Shard(d)`` where the spec lays tensor dim d over it,
        else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        if not is_device_mesh(self.mesh):
            raise TypeError("placements need a DeviceMesh; an abstract "
                            "mesh has no devices")
        out = []
        for name in axis_names(self.mesh):
            dims = [d for d, p in enumerate(spec)
                    if p == name or (isinstance(p, tuple) and name in p)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    # -- trees ---------------------------------------------------------------

    def tree_shardings(self, abstract_params, logical_tree):
        """A tree of tensors (or anything with a ``shape``: meta tensors)
        and the parallel tree of :class:`LogicalAxes` (dicts and lists
        alike) -> the same tree of :class:`NamedSharding`s."""
        def walk(leaf, ax, path):
            if isinstance(ax, LogicalAxes):
                return self.sharding(tuple(ax), tuple(leaf.shape), ax.name)
            if isinstance(ax, dict):
                if set(ax) != set(leaf):
                    raise ValueError(f"{path or 'params'}: keys "
                                     f"{sorted(leaf)} against axes "
                                     f"{sorted(ax)}")
                return {k: walk(leaf[k], ax[k], f"{path}.{k}")
                        for k in leaf}
            if isinstance(ax, (list, tuple)):
                if len(ax) != len(leaf):
                    raise ValueError(f"{path}: {len(leaf)} entries against "
                                     f"{len(ax)} axes")
                return type(ax)(walk(l, a, f"{path}[{i}]")
                                for i, (l, a) in enumerate(zip(leaf, ax)))
            raise TypeError(f"{path}: no logical axes for a "
                            f"{type(ax).__name__}")
        return walk(abstract_params, logical_tree, "")


def place(t, sharding: NamedSharding):
    """``t`` (the whole tensor, on this rank) as a DTensor laid out by
    ``sharding`` on its ``DeviceMesh``: each rank keeps its own chunk, cut
    locally (no collective; every rank holds the same ``t``).  A chunk
    that is all of ``t`` is ``t`` itself, not a copy."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    placements = Partitioner(mesh).placements(sharding.spec)
    coord = mesh.get_coordinate()
    local = t
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            local = local.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False)


class LogicalAxes(tuple):
    """A tuple of logical axis names acting as a tree *leaf*."""

    name: str = "?"

    def __new__(cls, axes: Sequence[str | None], name: str = "?"):
        obj = super().__new__(cls, axes)
        obj.name = name
        return obj

    def __repr__(self):
        return f"LogicalAxes({tuple(self)}, name={self.name!r})"


def logical(*axes: str | None, name: str = "?") -> LogicalAxes:
    return LogicalAxes(axes, name)


__all__ = ["AbstractMesh", "DEFAULT_RULES", "FallbackEvent", "LogicalAxes",
           "NamedSharding", "PartitionSpec", "Partitioner", "axis_names",
           "axis_size", "is_device_mesh", "logical", "place"]
