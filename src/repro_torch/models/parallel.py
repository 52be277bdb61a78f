"""The model zoo over a ``DeviceMesh``: params as DTensors, each rank's
step on its local shards (what the reference gets from GSPMD).

The reference places its params by ``Partitioner.tree_shardings`` on a
("data", "model") mesh and lets XLA insert the collectives.  Here:

* :func:`shard_tree` lays each leaf out as a DTensor by its
  ``NamedSharding`` (``partition.place``: each rank cuts its own chunk of
  the same seeded init), so checkpoints, restore and the dry-run's
  account see the layout;
* a step takes each leaf's local shard and all-gathers the leaves split
  over "data" along their d_model dim (FSDP, :func:`gather_params`): the
  result is the model as one model rank holds it, which the model
  functions run at the tp of the layout, calling Megatron's collectives
  themselves (``sharding.collectives``);
* the batch's rows split over "data" (:func:`split_rows`) where the
  data ranks divide them, and the logits come back whole
  (:func:`gather_rows`);
* after a training step's backward, :func:`reduce_grads` sums each
  gradient over the data ranks (a reduce-scatter for an FSDP leaf, an
  all-reduce for a replicated one) and over the model ranks for the
  leaves whose gradient each model rank holds only in part.

Everything here is a no-op on a mesh of one rank (the card's world).
"""

from __future__ import annotations

import torch

from ..sharding import collectives as C
from ..sharding.partition import axis_names, place


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _map(fn, tree, other=None, path=()):
    """``fn(path, leaf, other's leaf)`` over a tree of dicts, lists and
    tuples (``other`` parallel to it, or None)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if other is None else other[k],
                        path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, None if other is None else other[i], path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(path, tree, other)


def shard_tree(tree, shardings):
    """``tree``'s tensors as DTensors laid out by the parallel tree of
    ``NamedSharding``s (a None there keeps the leaf as it is)."""
    return _map(lambda _, t, sh: t if sh is None else place(t, sh),
                tree, shardings)


def _mesh_dim(t, name: str) -> int | None:
    names = axis_names(t.device_mesh)
    return names.index(name) if name in names else None


def _shard_dim(t, name: str) -> int | None:
    """The tensor dim the mesh axis ``name`` splits in DTensor ``t``."""
    i = _mesh_dim(t, name)
    if i is None or t.device_mesh.size(i) == 1:
        return None
    pl = t.placements[i]
    return pl.dim if pl.is_shard() else None


def _group(t, name: str):
    i = _mesh_dim(t, name)
    if i is None or t.device_mesh.size(i) == 1:
        return None
    return t.device_mesh.get_group(i)


def gather_params(tree):
    """Each DTensor leaf's local shard, all-gathered over "data" where the
    data axis splits it (FSDP): the params as this model rank holds them.
    A leaf that needs no gather is its local shard itself (same storage),
    so on one rank nothing is copied."""
    DTensor = _dtensor()

    def one(_, t, __):
        if not isinstance(t, DTensor):
            return t
        d = _shard_dim(t, "data")
        local = t.to_local()
        return local if d is None else C.all_gather(local, d,
                                                    _group(t, "data"))
    return _map(one, tree)


def reduce_grads(grads, params, partial=None):
    """The gradients of :func:`gather_params`' leaves -> DTensors laid out
    as ``params``: summed over "data" (reduce-scattered along a leaf's
    FSDP dim, else all-reduced) and, for a leaf the model axis leaves
    whole whose path ``partial(path)`` names, summed over "model"."""
    DTensor = _dtensor()

    def one(path, g, p):
        if not isinstance(p, DTensor):
            return g
        d = _shard_dim(p, "data")
        if d is not None:
            g = C.reduce_scatter(g, d, _group(p, "data"))
        else:
            g = C.all_reduce(g, _group(p, "data"))
        if (partial is not None and partial(path)
                and _shard_dim(p, "model") is None):
            g = C.all_reduce(g, _group(p, "model"))
        return DTensor.from_local(g, p.device_mesh, p.placements,
                                  run_check=False)
    return _map(one, grads, params)


def _data(mesh):
    """(rank, size) on the mesh's "data" axis."""
    if "data" not in axis_names(mesh):
        return 0, 1
    return mesh.get_local_rank("data"), mesh.size(
        axis_names(mesh).index("data"))


def split_rows(batch: dict, mesh, *, dim: int = 0,
               required: bool = False):
    """``(this data rank's rows of every entry of batch, split)``: the rows
    (dim ``dim``) cut into one block a data rank where the ranks divide
    them; otherwise every rank keeps them all (``split`` False), or with
    ``required`` ``ValueError``."""
    rank, n = _data(mesh)
    rows = int(next(iter(batch.values())).shape[dim])
    if n == 1 or rows % n:
        if required and n > 1:
            raise ValueError(f"{rows} rows do not split over {n} data "
                             f"ranks")
        return batch, False
    k = rows // n
    cut = (slice(None),) * dim + (slice(rank * k, (rank + 1) * k),)
    return {name: v[cut] for name, v in batch.items()}, True


def gather_rows(t: torch.Tensor, split: bool) -> torch.Tensor:
    """The ambient mesh's data ranks' rows of ``t`` (dim 0) in rank
    order, where :func:`split_rows` split them."""
    return C.all_gather(t, 0, C.data_group()) if split else t


__all__ = ["gather_params", "gather_rows", "reduce_grads", "shard_tree",
           "split_rows"]
