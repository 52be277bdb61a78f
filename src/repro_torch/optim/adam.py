"""Adam / AdamW over a tree of tensors, updated in place.

The PyTorch counterpart of ``repro.optim.adam``, written by hand because
``torch.optim.Adam`` computes another expression: the reference adds eps
after ``sqrt(v / bc2)``, corrects the bias with ``1 - b ** float32(step)``
and clamps the parameters (the DWN trainer keeps tables and scores in
[-1, 1]).  The step counter is an int32 tensor on the parameters' device,
so a schedule reads it there and a step captured in a CUDA graph needs
nothing from the host.  Params that are DTensors (a model over a
``DeviceMesh``) get moments laid out alike, and each rank updates its
local shards: Adam is elementwise, so no collective runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor   # int32, 0-dim, on the parameters' device
    mu: object           # tree like params
    nu: object


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _local(t):
    """A DTensor's local shard (its storage), any other tensor itself."""
    return t.to_local() if hasattr(t, "placements") else t


def map_tree(fn, tree):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0           # AdamW-style decoupled decay
    clamp: tuple | None = None          # optional (lo, hi) param clamp

    def init(self, params) -> AdamState:
        device = _local(leaves(params)[0]).device

        def zeros(t):
            z = torch.zeros_like(_local(t),
                                 memory_format=torch.contiguous_format)
            if t is _local(t):
                return z
            from torch.distributed.tensor import DTensor
            return DTensor.from_local(z, t.device_mesh, t.placements,
                                      run_check=False)
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         map_tree(zeros, params), map_tree(zeros, params))

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The float32 learning rate at optimizer step ``step``."""
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> None:
        """One Adam step: ``params``, ``state.mu``, ``state.nu`` and
        ``state.step`` are updated in place.

        Per element the expression is the reference's, operation for
        operation: ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``,
        ``p - lr*((m/bc1) / (sqrt(v/bc2) + eps) + wd*p)``, then the clamp
        (the ``wd*p`` term is left out when ``weight_decay`` is 0, where
        it adds zero).
        """
        state.step.add_(1)
        step = state.step.to(torch.float32)
        dev = step.device
        b1 = torch.full((), self.b1, dtype=torch.float32, device=dev)
        b2 = torch.full((), self.b2, dtype=torch.float32, device=dev)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        lr = self.lr_at(state.step)
        for p, m, v, g in zip(*(map(_local, leaves(t)) for t in (
                params, state.mu, state.nu, grads))):
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * (1 - self.b2) * g)
            upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
            if self.weight_decay:
                upd.add_(self.weight_decay * p)
            p.sub_(upd.mul_(lr))
            if self.clamp is not None:
                p.clamp_(self.clamp[0], self.clamp[1])


__all__ = ["Adam", "AdamState", "leaves", "map_tree"]
