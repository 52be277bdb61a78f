"""Sharding hints inside model code.

The PyTorch counterpart of the reference's ``repro.sharding.annotate``.
``hint(x, *spec_dims)`` lays ``x`` out as the spec says when a mesh is
ambient (set by :func:`use_mesh`, the counterpart of the reference's
``with mesh:``) and is a no-op otherwise (one device, the tests).  Under
a ``DeviceMesh`` a DTensor is redistributed to the spec's placements; a
plain tensor passes through, since it is not laid over the mesh.

Why the hints exist: with only the parameters' layouts given, activations
can end up laid out like the weights (d_model sharded, the batch
replicated), so each device computes attention for the whole batch.
Pinning activations to (batch over the data axes, heads / ff over
"model") keeps the Megatron/FSDP execution.
"""

from __future__ import annotations

import contextlib
import threading

from .partition import PartitionSpec, Partitioner, axis_names

_AMBIENT = threading.local()


def current_mesh():
    """The innermost mesh of :func:`use_mesh` on this thread, or None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``) ambient on
    this thread for the ``with`` block."""
    stack = getattr(_AMBIENT, "stack", None)
    if stack is None:
        stack = _AMBIENT.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _ambient_axis_names() -> tuple[str, ...]:
    mesh = current_mesh()
    return axis_names(mesh) if mesh is not None else ()


def dp_axes() -> tuple[str, ...]:
    """The data-parallel mesh axes present in the ambient mesh."""
    names = _ambient_axis_names()
    return tuple(a for a in ("pod", "data") if a in names)


def _spec(spec_dims, names) -> PartitionSpec:
    dims = []
    for d in spec_dims:
        if d == "dp":
            dp = dp_axes()
            dims.append(dp if len(dp) > 1 else (dp[0] if dp else None))
        elif isinstance(d, str) and d not in names:
            dims.append(None)
        else:
            dims.append(d)
    return PartitionSpec(*dims)


def hint(x, *spec_dims):
    """Lay ``x`` out as PartitionSpec(*spec_dims) if a mesh is ambient.

    ``"dp"`` in spec_dims resolves to the ambient ("pod", "data") axes;
    any axis name missing from the mesh degrades that dim to None.  Only
    a DTensor on a ``DeviceMesh`` moves; anything else is returned as is.
    """
    names = _ambient_axis_names()
    if not names:
        return x
    spec = _spec(spec_dims, names)
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if not isinstance(x, DTensor) or not hasattr(mesh, "mesh_dim_names"):
        return x
    return x.redistribute(mesh, Partitioner(mesh).placements(spec))


def hint_act(x):
    """(B, S, D) residual-stream activations: batch over DP."""
    return hint(x, "dp", *([None] * (x.ndim - 1)))


def hint_heads(x, axis: int = 2):
    """(B, S, H, hd)-style tensors: batch over DP, heads over model."""
    dims: list = ["dp"] + [None] * (x.ndim - 1)
    dims[axis] = "model"
    return hint(x, *dims)


__all__ = ["current_mesh", "dp_axes", "hint", "hint_act", "hint_heads",
           "use_mesh"]
