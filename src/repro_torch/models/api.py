"""Model-zoo API of the port: family dispatch and the step factories the
serving engine and the train CLI call (the reference's
``repro.models.api``).

    make_optimizer(lr)                -> Adam (the reference's LM AdamW)
    make_train_step(cfg, *, num_micro, opt, clip_norm)
                                      -> (step(params, opt, batch), opt)
    make_prefill(cfg, cache_len=None) -> fn(params, batch)
    make_decode_step(cfg)             -> fn(params, cache, batch)
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..optim.adam import Adam, leaves
from ..optim.grad import accumulate_grads, clip_by_global_norm, value_and_grad
from . import transformer

MODULES = {"dense": transformer}


def module_for(cfg: ArchConfig):
    """The model module of ``cfg.family``; ``NotImplementedError`` for a
    family the port does not run yet (ROADMAP Queue 1 item 8)."""
    if cfg.family not in MODULES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue 1 item 8); the port runs {sorted(MODULES)}")
    return MODULES[cfg.family]


def make_optimizer(lr: float = 3e-4) -> Adam:
    return Adam(lr=lr, b1=0.9, b2=0.95, weight_decay=0.1)


def make_train_step(cfg: ArchConfig, *, num_micro: int = 1,
                    opt: Adam | None = None, clip_norm: float = 1.0):
    """Returns ``(step, opt)``; ``step(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm"})`` with the reference's arithmetic:
    the loss and its gradients (with ``num_micro > 1`` the batch leaves
    carry a leading (num_micro, micro_b) pair, and the loss and gradients
    are summed microbatch by microbatch in a loop and scaled by
    ``1 / num_micro``), clipped to ``clip_norm`` by their global norm, then
    one Adam step.

    ``params`` must be the float32 training form
    (``init_params(..., dtype=torch.float32)``); they and ``opt_state``
    are updated in place and returned.  ``loss`` and ``grad_norm`` are
    float32 tensors on the params' device.
    """
    mod = module_for(cfg)
    opt = opt or make_optimizer()

    def loss_of(params, data):
        return mod.loss_fn(params, cfg, data), None

    def step(params, opt_state, batch):
        bad = sorted({str(t.dtype) for t in leaves(params)
                      if t.dtype != torch.float32})
        if bad:
            raise ValueError(
                f"{cfg.name}: training needs float32 params (the master "
                f"weights; got {bad}): init_params(..., "
                f"dtype=torch.float32)")
        if num_micro == 1:
            (loss, _), grads = value_and_grad(loss_of, params, batch)
        else:
            loss, grads = accumulate_grads(loss_of, params, batch, num_micro)
        with torch.profiler.record_function("lm.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                               in_place=True)
        with torch.profiler.record_function("lm.adam"):
            opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step, opt


def make_prefill(cfg: ArchConfig, *, cache_len: int | None = None):
    mod = module_for(cfg)

    def fn(params, batch):
        return mod.prefill(params, cfg, batch, cache_len=cache_len)

    return fn


def make_decode_step(cfg: ArchConfig):
    mod = module_for(cfg)

    def fn(params, cache, batch):
        return mod.decode_step(params, cfg, cache, batch["tokens"])

    return fn


__all__ = ["MODULES", "make_decode_step", "make_optimizer", "make_prefill",
           "make_train_step", "module_for"]
