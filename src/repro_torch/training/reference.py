"""The per-minibatch training loop, kept as the engine's parity oracle.

The PyTorch counterpart of ``repro.training.reference``: the reference's
pre-engine trainer, with its structure kept as the oracle the engine is
tested against:

* one step a minibatch from ``data.jsc.batches``, the loss fetched to the
  host every step;
* the thermometer encode of every batch inside the step;
* the textbook softmax-STE backward (``x_soft`` and two more products,
  not the reassociated ``_d_scores``);
* Adam as three passes over the parameters (moments first, then the
  update from them), the same arithmetic as ``optim.Adam.update``.

Do not improve this file: its value is staying the same arithmetic by
another route.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.classifier import (accuracy, cross_entropy, group_popcount,
                               logits_from_counts)
from ..core.lut_layer import _addresses
from ..core.model import DWNConfig, init_dwn
from ..core.thermometer import encode, quantize_fixed_point
from ..data.jsc import batches
from ..device import resolve_device
from ..optim.adam import Adam, AdamState, leaves, map_tree
from .engine import make_optimizer, owned


def _adam_update_ref(opt: Adam, grads, state: AdamState, params):
    """Three passes: every first moment, every second moment, then the
    update reading them; returns (new params, new state)."""
    step = state.step + 1
    b1, b2 = opt.b1, opt.b2
    mu = [b1 * m + (1 - b1) * g
          for m, g in zip(leaves(state.mu), leaves(grads))]
    nu = [b2 * v + (1 - b2) * g * g
          for v, g in zip(leaves(state.nu), leaves(grads))]
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.full_like(stepf, b1) ** stepf
    bc2 = 1 - torch.full_like(stepf, b2) ** stepf
    lr = opt.lr_at(step)
    new = []
    for p, m, v in zip(leaves(params), mu, nu):
        mhat = m / bc1
        vhat = v / bc2
        upd = p - lr * (mhat / (torch.sqrt(vhat) + opt.eps)
                        + opt.weight_decay * p)
        if opt.clamp is not None:
            upd = torch.clamp(upd, opt.clamp[0], opt.clamp[1])
        new.append(upd)
    rebuild = lambda flat: _unflatten(params, iter(flat))  # noqa: E731
    return rebuild(new), AdamState(step, rebuild(mu), rebuild(nu))


def _unflatten(tree, it):
    return map_tree(lambda _: next(it), tree)


class _SelectBitsRef(torch.autograd.Function):
    """``bits[:, argmax scores]``; the textbook softmax-STE backward."""

    @staticmethod
    def forward(ctx, bits, scores):
        idx = torch.argmax(scores, dim=-1)
        ctx.save_for_backward(bits, scores)
        return bits[:, idx.reshape(-1)].view(bits.shape[0], *idx.shape)

    @staticmethod
    def backward(ctx, g):
        bits, scores = ctx.saved_tensors
        p = torch.softmax(scores, dim=-1)                    # (m, n, C)
        d_bits = torch.einsum("bmn,mnc->bc", g, p)
        x_soft = torch.einsum("mnc,bc->bmn", p, bits)
        gb = torch.einsum("bmn,bc->mnc", g, bits)
        gx = torch.einsum("bmn,bmn->mn", g, x_soft)
        return d_bits, p * (gb - gx[..., None])


class _LUTLookupRef(torch.autograd.Function):
    """``tables[lut, addr] > 0``; EFD backward, the entries re-read."""

    @staticmethod
    def forward(ctx, sel_bits, tables):
        addr = _addresses(sel_bits)
        B = addr.shape[0]
        vals = torch.take_along_dim(
            tables[None].expand(B, *tables.shape), addr[..., None],
            dim=-1)[..., 0]
        ctx.save_for_backward(tables, addr)
        return (vals > 0.0).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        tables, addr = ctx.saved_tensors
        B, S = addr.shape[0], tables.shape[1]
        n = S.bit_length() - 1
        wide = tables[None].expand(B, *tables.shape)
        vals = torch.take_along_dim(wide, addr[..., None], dim=-1)[..., 0]
        g_vals = g * (vals.abs() <= 1.0).to(g.dtype)
        onehot = (addr[..., None] == torch.arange(
            S, device=addr.device)).to(g.dtype)
        d_tables = torch.einsum("bm,bms->ms", g_vals, onehot)
        bit_w = 2 ** torch.arange(n, dtype=torch.int64, device=addr.device)
        t_hi = torch.take_along_dim(wide, addr[..., None] | bit_w, dim=-1)
        t_lo = torch.take_along_dim(wide, addr[..., None] & ~bit_w, dim=-1)
        return g_vals[..., None] * (t_hi - t_lo), d_tables


def apply_train_ref(params, buffers, cfg: DWNConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """The loop's differentiable forward (encode per batch, its own ops)."""
    bits = encode(x, buffers["thresholds"]).detach()
    for layer in params["layers"]:
        sel = _SelectBitsRef.apply(bits, layer["scores"])
        bits = _LUTLookupRef.apply(sel, layer["tables"])
    counts = group_popcount(bits, cfg.num_classes)
    return logits_from_counts(counts, cfg.tau_value)


def _update_ref(cfg, opt, input_frac_bits, params, opt_state, buffers,
                x, y):
    if input_frac_bits is not None:
        x = quantize_fixed_point(x, input_frac_bits)
    live = map_tree(lambda t: t.detach().requires_grad_(), params)
    logits = apply_train_ref(live, buffers, cfg, x)
    loss = cross_entropy(logits, y)
    grads = torch.autograd.grad(loss, leaves(live))
    with torch.no_grad():
        params, opt_state = _adam_update_ref(opt, list(grads), opt_state,
                                             params)
    return params, opt_state, loss.detach(), accuracy(logits.detach(), y)


@torch.no_grad()
def eval_soft_ref(params, buffers, cfg, x, y, input_frac_bits=None,
                  batch: int = 4096) -> float:
    """The loop's eval: batches of ``batch``, their accuracies averaged
    with the batch sizes as weights."""
    device = buffers["thresholds"].device
    accs, ns = [], []
    for i in range(0, x.shape[0], batch):
        xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch],
                                                   np.float32)).to(device)
        yb = torch.from_numpy(np.asarray(y[i:i + batch], np.int64)).to(
            device)
        if input_frac_bits is not None:
            xb = quantize_fixed_point(xb, input_frac_bits)
        accs.append(float(accuracy(apply_train_ref(params, buffers, cfg,
                                                   xb), yb)))
        ns.append(xb.shape[0])
    return float(np.average(accs, weights=ns))


class ReferenceTrainer:
    """The loop, an epoch at a time."""

    def __init__(self, cfg: DWNConfig, data, *, batch: int = 128,
                 lr: float = 1e-3, sched: str = "steplr", seed: int = 0,
                 params=None, buffers=None,
                 input_frac_bits: int | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg, self.data = cfg, data
        self.batch, self.seed = batch, seed
        self.input_frac_bits = input_frac_bits
        if params is None:
            params, buffers = init_dwn(torch.Generator().manual_seed(seed),
                                       cfg, data.x_train)
        self.params = map_tree(lambda t: owned(t, self.device), params)
        self.buffers = map_tree(lambda t: owned(t, self.device), buffers)
        self.opt = make_optimizer(lr, sched, data.x_train.shape[0] // batch)
        self.opt_state = self.opt.init(self.params)
        self.epoch = 0

    def run_epoch(self) -> list:
        """One epoch: a step a minibatch, each loss fetched."""
        losses = []
        for xb, yb in batches(self.data.x_train, self.data.y_train,
                              self.batch, seed=self.seed, epoch=self.epoch):
            self.params, self.opt_state, loss, _ = _update_ref(
                self.cfg, self.opt, self.input_frac_bits, self.params,
                self.opt_state, self.buffers,
                torch.from_numpy(xb).to(self.device),
                torch.from_numpy(yb.astype(np.int64)).to(self.device))
            losses.append(float(loss))
        self.epoch += 1
        return losses

    def evaluate(self) -> float:
        return eval_soft_ref(self.params, self.buffers, self.cfg,
                             self.data.x_test, self.data.y_test,
                             self.input_frac_bits)


def train_dwn_reference(cfg: DWNConfig, data, *, epochs: int = 30,
                        batch: int = 128, lr: float = 1e-3, seed: int = 0,
                        params=None, buffers=None,
                        input_frac_bits: int | None = None,
                        sched: str = "steplr", verbose: bool = False,
                        device=None):
    """The loop end to end (eval after every epoch); a ``TrainResult``."""
    from ..core.training import TrainResult
    t = ReferenceTrainer(cfg, data, batch=batch, lr=lr, sched=sched,
                         seed=seed, params=params, buffers=buffers,
                         input_frac_bits=input_frac_bits, device=device)
    history = []
    for epoch in range(epochs):
        t0 = time.time()
        losses = t.run_epoch()
        te_acc = t.evaluate()
        history.append({"epoch": epoch, "loss": float(np.mean(losses)),
                        "test_acc": te_acc, "sec": time.time() - t0})
        if verbose:
            print(f"  epoch {epoch:3d} loss={np.mean(losses):.4f} "
                  f"test_acc={te_acc:.4f} ({time.time() - t0:.1f}s)",
                  flush=True)
    return TrainResult(t.params, t.buffers, cfg, history,
                       history[-1]["test_acc"] if history else float("nan"))


__all__ = ["ReferenceTrainer", "apply_train_ref", "eval_soft_ref",
           "train_dwn_reference"]
