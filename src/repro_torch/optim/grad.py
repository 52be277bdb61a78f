"""Gradient processing for LM training: the PyTorch counterpart of the
reference's ``repro.optim.grad``.

* global-norm clipping,
* microbatch gradient accumulation (a Python loop over microbatches with
  autograd; the reference scans),
* top-k gradient compression with error feedback (EF-SGD style).

Trees are the port's nested dicts and lists of tensors
(``optim.adam.leaves`` / ``map_tree``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .adam import leaves, map_tree


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [torch.sum(x.float() ** 2) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float, *, in_place: bool = False):
    """``(tree * min(1, max_norm / (norm + 1e-12)), norm)``.  With
    ``in_place`` the leaves are scaled where they are (the train step
    owns its gradients, and a copy of them at full width would not fit
    beside the model) and ``tree`` itself is returned."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    if in_place:
        for x in leaves(tree):
            x.mul_(scale)
        return tree, norm
    return map_tree(lambda x: x * scale, tree), norm


def _requiring_grad(params):
    """``params`` as leaves that require grad (views of the same storage
    where a leaf does not already)."""
    return map_tree(lambda t: t if t.requires_grad
                    else t.detach().requires_grad_(True), params)


def value_and_grad(loss_fn, params, *args):
    """``(loss, aux), grads`` of ``loss_fn(params, *args) -> (loss, aux)``
    with respect to every leaf of ``params``, as a tree like it."""
    p = _requiring_grad(params)
    loss, aux = loss_fn(p, *args)
    flat = leaves(p)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    # a leaf the loss does not reach gets zeros, as under jax.grad; each
    # gradient gets storage of its own (autograd may hand back an
    # expanded view), since accumulation and clipping write in place
    it = iter([torch.zeros_like(t) if g is None else g.contiguous()
               for t, g in zip(flat, grads)])
    # ``leaves`` walks dicts in sorted key order; rebuild in that order
    return (loss.detach(), aux), _unflatten_like(p, it)


def _unflatten_like(tree, it):
    if isinstance(tree, dict):
        out = {k: _unflatten_like(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, it) for v in tree)
    return next(it)


def accumulate_grads(loss_fn, params, batches, num_micro: int):
    """Average grads over ``num_micro`` microbatches.

    ``loss_fn(params, micro) -> (loss, aux)``; ``batches`` is a tree whose
    leaves have a leading (num_micro, ...) dim.  The sums are the
    reference's: the losses and gradients added microbatch by microbatch
    in order, each sum scaled by ``1 / num_micro`` at the end.  Returns
    ``(mean_loss, mean_grads)``.
    """
    loss_sum, grad_sum = None, None
    for i in range(num_micro):
        micro = map_tree(lambda x: x[i], batches)
        (loss, _), grads = value_and_grad(loss_fn, params, micro)
        if grad_sum is None:
            loss_sum, grad_sum = loss, grads
        else:
            loss_sum = loss_sum + loss
            for acc, g in zip(leaves(grad_sum), leaves(grads)):
                acc.add_(g)
    k = 1.0 / num_micro
    return loss_sum * k, map_tree(lambda g: g.mul_(k), grad_sum)


class CompressionState(NamedTuple):
    error: object  # tree of residuals (error-feedback memory)


def topk_compress_init(params) -> CompressionState:
    return CompressionState(map_tree(torch.zeros_like, params))


def topk_compress(grads, state: CompressionState, k_frac: float = 0.01):
    """Keep the top ``k_frac`` fraction of entries (by |g|) per leaf; the
    rest accumulates into the error-feedback residual for the next step.

    Returns ``(sparse_grads, new_state)``: dense tensors with zeros outside
    the top-k support (every entry whose magnitude reaches the k-th
    largest, ties included, as in the reference).
    """
    def one(g, e):
        g = g + e
        flat = torch.abs(g).reshape(-1)
        k = max(1, int(flat.shape[0] * k_frac))
        thresh = torch.topk(flat, k).values[-1]
        mask = (torch.abs(g) >= thresh).to(g.dtype)
        sent = g * mask
        return sent, g - sent

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(state.error))]
    sent = _unflatten_like(grads, iter([o[0] for o in out]))
    resid = _unflatten_like(grads, iter([o[1] for o in out]))
    return sent, CompressionState(resid)


__all__ = [
    "CompressionState", "accumulate_grads", "clip_by_global_norm",
    "global_norm", "topk_compress", "topk_compress_init", "value_and_grad",
]
