"""The collectives of the model's tensor- and data-parallel step, made
explicit.

The reference lays its params out by the partitioner, pins activations
with ``hint`` and lets XLA insert the collectives (GSPMD).  PyTorch has
no such compiler, so the port runs each rank's local shards through the
model functions and calls each collective where the reference's hints
put one (``models.parallel`` places the params and splits the batch):

* Megatron's pair over "model": :func:`copy_to_model` (*f*: the identity
  forward, an all-reduce of the gradient backward) at the input of a
  column-parallel product (QKV, gate/up, the experts' input and gates,
  the unembedding), and :func:`reduce_from_model` (*g*: an all-reduce
  forward, the identity backward) after a row-parallel one (the attention
  output, the MLP's and the experts' down projections, the vocab-split
  embedding lookup);
* :func:`gather_from_model`: the vocab-split logits gathered over
  "model" (backward: this rank's slice of the gradient);
* :func:`gather_for_model`: a model-split tensor gathered for a product
  every rank runs on the whole of it (the RG-LRU gates' input, mamba2's
  convolution params): backward, every rank's gradient summed and this
  rank's slice kept (a reduce-scatter);
* :func:`sum_over_model`: a sum every model rank reads whole (an RMS
  norm's sum of squares over a model-split dimension): an all-reduce
  forward and backward, since each rank's output depends on it and so
  each rank holds only part of its gradient;
* :func:`sum_over_data` / :func:`mean_over_data`: the loss's and the MoE
  aux loss's means over the global batch, whose rows the data ranks
  split (an all-reduce forward, the identity backward), live only inside
  :func:`batch_split`;
* :func:`all_gather`, :func:`reduce_scatter` and :func:`all_reduce` on
  a group: the FSDP gathers of the params and the reductions of their
  gradients (``models.parallel``), outside autograd.

Each reads the ambient mesh (``annotate.use_mesh``) and is a no-op
without a ``DeviceMesh`` or where its axis has one rank.  They are
functional collectives (``torch.distributed._functional_collectives``),
each waited on before it returns, so ``CommDebugMode`` counts every one.
The data axis of a ``DeviceMesh`` is "data" alone (``launch.mesh``'s
host mesh); a "pod" axis on one raises.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .annotate import current_mesh, use_mesh
from .partition import axis_names, is_device_mesh

_STATE = threading.local()


def _device_mesh():
    """The ambient mesh when it is a ``DeviceMesh``, else None."""
    mesh = current_mesh()
    return mesh if is_device_mesh(mesh) else None


def _axis(name: str):
    """(group, rank, size) of the ambient ``DeviceMesh``'s axis ``name``;
    (None, 0, 1) without one, or where the axis is absent or one rank."""
    mesh = _device_mesh()
    if mesh is None:
        return None, 0, 1
    names = axis_names(mesh)
    if "pod" in names:
        raise NotImplementedError(
            "a DeviceMesh with a 'pod' axis: the port's step reduces over "
            "'data' alone")
    if name not in names:
        return None, 0, 1
    n = mesh.size(names.index(name))
    if n == 1:
        return None, 0, 1
    return mesh.get_group(name), mesh.get_local_rank(name), n


def model_group():
    return _axis("model")[0]


def data_group():
    return _axis("data")[0]


def model_rank() -> int:
    return _axis("model")[1]


def model_size() -> int:
    return _axis("model")[2]


def active() -> bool:
    """Whether a collective of the ambient mesh runs: a ``DeviceMesh``
    with more than one rank."""
    mesh = _device_mesh()
    return mesh is not None and mesh.size() > 1


# ---------------------------------------------------------------------------
# functional collectives, waited on
# ---------------------------------------------------------------------------

def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (``t`` itself without one)."""
    if group is None:
        return t
    f = _funcol()
    return f.wait_tensor(f.all_reduce(t.contiguous(), "sum", group))


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``group``'s shards of ``t`` concatenated along ``dim`` in rank
    order."""
    if group is None:
        return t
    f = _funcol()
    gather = getattr(f, "all_gather_single", None) or f.all_gather_tensor
    return f.wait_tensor(gather(t.contiguous(), dim % t.ndim, group))


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's slice along ``dim``."""
    if group is None:
        return t
    f = _funcol()
    scatter = (getattr(f, "reduce_scatter_single", None)
               or f.reduce_scatter_tensor)
    return f.wait_tensor(scatter(t.contiguous(), "sum", dim % t.ndim,
                                 group))


# ---------------------------------------------------------------------------
# the autograd pieces
# ---------------------------------------------------------------------------

class _ReduceForward(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBackward(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward (f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, n):
        ctx.dim, ctx.rank, ctx.n = dim, rank, n
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        part = grad.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous()
        return part, None, None, None, None


class _ReduceBoth(torch.autograd.Function):
    """All-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _GatherSum(torch.autograd.Function):
    """All-gather along ``dim`` forward; the sum of the gradients, this
    rank's slice, backward (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f over "model": ``x`` forward, its gradient summed over
    the model ranks backward."""
    group = model_group()
    return x if group is None else _ReduceBackward.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g over "model": the partial sums ``x`` summed over the
    model ranks forward, the gradient passed through backward."""
    group = model_group()
    return x if group is None else _ReduceForward.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model ranks' shards of ``x`` concatenated along ``dim``."""
    group, rank, n = _axis("model")
    if group is None:
        return x
    return _Gather.apply(x, dim % x.ndim, group, rank, n)


def gather_for_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model ranks' shards of ``x`` concatenated along ``dim``, for a
    product every rank runs on the whole of it: each rank then holds part
    of the gradient, so the backward sums them and keeps this rank's
    slice."""
    group = model_group()
    return x if group is None else _GatherSum.apply(x, dim % x.ndim, group)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model ranks, forward and backward: a sum
    whose value every rank's output reads."""
    group = model_group()
    return x if group is None else _ReduceBoth.apply(x, group)


# ---------------------------------------------------------------------------
# means over the global batch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def batch_split():
    """Inside the block the batch's rows are split over the ambient
    mesh's "data" ranks: :func:`sum_over_data` and :func:`mean_over_data`
    reduce over them (outside it they pass ``x`` through)."""
    prev = getattr(_STATE, "split", False)
    _STATE.split = True
    try:
        yield
    finally:
        _STATE.split = prev


def ambient():
    """A context manager that re-enters the caller's ambient mesh and
    :func:`batch_split` on whichever thread enters it (autograd runs a
    card's backward, and so a recomputed block, on a thread of its
    own)."""
    mesh = current_mesh()
    split = getattr(_STATE, "split", False)

    @contextlib.contextmanager
    def enter():
        prev = getattr(_STATE, "split", False)
        _STATE.split = split
        try:
            with (use_mesh(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                yield
        finally:
            _STATE.split = prev

    return enter


def _split_data():
    if not getattr(_STATE, "split", False):
        return None, 1
    group, _, n = _axis("data")
    return group, n


def reduces_over_data() -> bool:
    """Whether :func:`sum_over_data` and :func:`mean_over_data` reduce
    here: inside :func:`batch_split` on a mesh of several data ranks."""
    return _split_data()[0] is not None


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks inside :func:`batch_split` (the
    gradient passed through)."""
    group, _ = _split_data()
    return x if group is None else _ReduceForward.apply(x, group)


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """The mean of the data ranks' ``x`` (each a mean over its rows)
    inside :func:`batch_split`."""
    group, n = _split_data()
    return x if group is None else _ReduceForward.apply(x, group) / n


__all__ = ["active", "all_gather", "ambient", "all_reduce", "batch_split",
           "copy_to_model", "data_group", "gather_for_model",
           "gather_from_model",
           "mean_over_data", "model_group", "model_rank", "model_size",
           "reduce_from_model", "reduce_scatter", "reduces_over_data",
           "sum_over_data", "sum_over_model"]
