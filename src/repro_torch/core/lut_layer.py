"""DWN LUT layer with Extended-Finite-Difference gradients, and its hard
(frozen, hardware-semantics) paths.

The PyTorch counterpart of ``repro.core.lut_layer``.  Each of the ``m``
LUTs reads ``n`` candidate bits chosen by a learnable mapping (an
(m, n, C) score matrix) and addresses a truth table of ``2^n`` entries
with them; bit ``i`` of the address is the ``i``-th selected bit.

* Forward, the mapping is the scores' first argmax and the table entry's
  sign is the output bit (what the hardware wires and stores).
* Backward, the mapping relaxes through a softmax (straight-through
  estimator, :class:`_SelectBits`), and the table read through the
  Extended Finite Difference (:class:`_LUTLookupEFD`): the gradient to
  input bit ``i`` is the difference of the two entries whose addresses
  differ in bit ``i``; the gradient to the table goes to the addressed
  entry, clipped to ``|entry| <= 1``.

Both are ``torch.autograd.Function``s of plain tensor ops: the reference
has no Pallas kernel on this path (its ``custom_vjp``s are plain jnp).
Every sum is one the reference takes too, in a fixed order: the table
gradient is a one-hot product, not a scatter-add, whose float atomics on
CUDA would add in an order that changes from run to run.
"""

from __future__ import annotations

import dataclasses

import torch

from .bitpack import PackedBits, lut_addresses, select_packed_bits


@dataclasses.dataclass(frozen=True)
class LUTLayerSpec:
    num_luts: int            # m
    fan_in: int = 6          # n (physical LUT6)
    num_candidates: int = 0  # C — set from the encoder / previous layer

    @property
    def table_size(self) -> int:
        return 2 ** self.fan_in


def init_lut_layer(generator: torch.Generator, spec: LUTLayerSpec, *,
                   device="cpu"):
    """Initialize {scores, tables}: tables ~ U(-1, 1), scores ~ 0.01 N(0, 1).

    Draws from ``generator`` (on the CPU) and moves the result to
    ``device``.  torch's generator gives other numbers than ``jax.random``
    for the same seed, so a port-initialized layer differs from the
    reference's; carry the reference's parameters across with
    ``core.model.params_from_numpy`` to compare the two.
    """
    scores = torch.randn((spec.num_luts, spec.fan_in, spec.num_candidates),
                         generator=generator, dtype=torch.float32) * 0.01
    tables = torch.rand((spec.num_luts, spec.table_size),
                        generator=generator, dtype=torch.float32) * 2.0 - 1.0
    return {"scores": scores.to(device), "tables": tables.to(device)}


def first_max_index(x: torch.Tensor) -> torch.Tensor:
    """First index of the row maximum over the last axis (ties go to the
    lowest index, as ``torch.argmax`` documents), as int32."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def finalize_mapping(params) -> torch.Tensor:
    """Freeze the learnable mapping to int32 wire indices (m, n)."""
    return first_max_index(params["scores"])


def binarize_tables(params) -> torch.Tensor:
    """Freeze truth tables to {0,1} int32 (m, 2^n) — the hardware LUT INIT."""
    return (params["tables"] > 0.0).to(torch.int32)


def _addresses(sel_bits: torch.Tensor) -> torch.Tensor:
    """(B, m, n) {0,1} -> (B, m) int64 address; bit i has weight 2^i."""
    n = sel_bits.shape[-1]
    weights = 2 ** torch.arange(n, dtype=torch.int64, device=sel_bits.device)
    return (sel_bits.to(torch.int64) * weights).sum(dim=-1)


def _read_tables(tables_bin: torch.Tensor, addr: torch.Tensor):
    """tables (m, S), addr (B, m) -> (B, m) table entries."""
    m = tables_bin.shape[0]
    lut = torch.arange(m, device=addr.device)
    return tables_bin[lut[None, :], addr]


# ---------------------------------------------------------------------------
# Training: binarized table read with the EFD backward, and the learnable
# mapping (hard argmax forward, softmax straight-through backward).
# ---------------------------------------------------------------------------

def _gather_flat(tables: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """tables (m, S), addr (B, m) or (B, m, n) -> the entries at
    ``tables[lut, addr]``, read as one flat take."""
    m, S = tables.shape
    offs = torch.arange(m, dtype=torch.int64, device=addr.device) * S
    offs = offs.view(1, m, *([1] * (addr.dim() - 2)))
    return tables.reshape(-1)[addr + offs]


class _LUTLookupEFD(torch.autograd.Function):
    """sel_bits (B, m, n) {0,1} float, tables (m, 2^n) float -> (B, m)
    {0,1} float bits: ``tables[lut, addr] > 0``."""

    @staticmethod
    def forward(ctx, sel_bits, tables):
        with torch.profiler.record_function("train.lut_fwd"):
            addr = _addresses(sel_bits)                      # (B, m)
            vals = _gather_flat(tables, addr)                # (B, m)
            ctx.save_for_backward(tables, addr, vals)
            return (vals > 0.0).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        tables, addr, vals = ctx.saved_tensors
        with torch.profiler.record_function("train.lut_bwd"):
            S = tables.shape[1]
            n = S.bit_length() - 1                           # S == 2^n
            # straight-through sign, clipped to its linear region
            g_vals = g * (vals.abs() <= 1.0).to(g.dtype)
            d_tables = None
            if ctx.needs_input_grad[1]:
                lanes = torch.arange(S, dtype=torch.int64,
                                     device=addr.device)
                onehot = (addr[..., None] == lanes).to(g.dtype)  # (B,m,S)
                d_tables = torch.einsum("bm,bms->ms", g_vals, onehot)
            d_sel = None
            if ctx.needs_input_grad[0]:
                bit_w = 2 ** torch.arange(n, dtype=torch.int64,
                                          device=addr.device)
                t_hi = _gather_flat(tables, addr[..., None] | bit_w)
                t_lo = _gather_flat(tables, addr[..., None] & ~bit_w)
                d_sel = g_vals[..., None] * (t_hi - t_lo)   # (B, m, n)
            return d_sel, d_tables


def _d_scores(scores, vmax, g, bits):
    """dL/dscores of the softmax straight-through relaxation, with the
    reference's reassociation (``repro.core.lut_layer._d_scores``).

    With p = softmax(scores), e = exp(scores - max), s = Σ_c e and
    gb = Σ_b g·bits, the textbook ``p·(gb - Σ_c p·gb)`` is computed as
    ``e·(gb - Σ_c e·gb / s) / s``: p is never materialized.
    """
    m, n, C = scores.shape
    with torch.profiler.record_function("train.ste"):
        e = torch.exp(scores - vmax)                         # (m, n, C)
        se = e.sum(dim=-1, keepdim=True)
    with torch.profiler.record_function("train.gb"):
        gb = (g.reshape(g.shape[0], m * n).t() @ bits).view(m, n, C)
    with torch.profiler.record_function("train.ste"):
        gxn = (e * gb).sum(dim=-1, keepdim=True)
        # e * (gb - gxn / se) / se, in place on gb
        return gb.sub_(gxn / se).mul_(e).div_(se)


class _SelectBits(torch.autograd.Function):
    """bits (B, C), scores (m, n, C) -> the selected bits (B, m, n):
    ``bits[:, argmax_c scores]``, ties to the lowest candidate.

    The backward returns the bits' gradient only where autograd asks for
    it: a first layer fed by the (never trained) encoder gets no
    (B, m·n) x (m·n, C) product, as the reference's
    ``_select_bits_stopgrad`` declares.
    """

    @staticmethod
    def forward(ctx, bits, scores):
        with torch.profiler.record_function("train.select_fwd"):
            vmax = scores.amax(dim=-1, keepdim=True)
            idx = torch.argmax(scores, dim=-1)               # (m, n)
            sel = bits.index_select(1, idx.reshape(-1))
            ctx.save_for_backward(bits, scores, vmax)
            return sel.view(bits.shape[0], *idx.shape)

    @staticmethod
    def backward(ctx, g):
        bits, scores, vmax = ctx.saved_tensors
        d_bits = None
        if ctx.needs_input_grad[0]:
            with torch.profiler.record_function("train.d_bits"):
                e = torch.exp(scores - vmax)
                p = e / e.sum(dim=-1, keepdim=True)          # softmax
                m, n, C = scores.shape
                d_bits = g.reshape(g.shape[0], m * n) @ p.view(m * n, C)
        d_scores = (_d_scores(scores, vmax, g, bits)
                    if ctx.needs_input_grad[1] else None)
        return d_bits, d_scores


def lut_layer_apply(params, bits: torch.Tensor) -> torch.Tensor:
    """Differentiable DWN LUT layer: (B, C) bits -> (B, m) bits."""
    sel = _SelectBits.apply(bits, params["scores"])          # (B, m, n)
    return _LUTLookupEFD.apply(sel, params["tables"])        # (B, m)


def lut_layer_apply_stopgrad(params, bits: torch.Tensor) -> torch.Tensor:
    """:func:`lut_layer_apply` on bits that take no gradient (the first
    layer, fed by the encoder): the backward computes no bits gradient."""
    return lut_layer_apply(params, bits.detach())


def lut_eval_hard(bits: torch.Tensor, mapping_idx: torch.Tensor,
                  tables_bin: torch.Tensor) -> torch.Tensor:
    """Pure inference path (the hardware semantics).

    Args:
      bits: (B, C) float or int {0,1}.
      mapping_idx: (m, n) int wire indices.
      tables_bin: (m, 2^n) int {0,1} truth tables.
    Returns (B, m) float32 bits.
    """
    B = bits.shape[0]
    m, n = mapping_idx.shape
    sel = bits[:, mapping_idx.reshape(-1).long()].reshape(B, m, n)
    return _read_tables(tables_bin, _addresses(sel)).to(torch.float32)


def lut_eval_hard_packed(packed: PackedBits, mapping_idx: torch.Tensor,
                         tables_bin: torch.Tensor) -> PackedBits:
    """Packed twin of :func:`lut_eval_hard`: a mapped candidate bit ``idx``
    is read from word ``idx >> 5`` at position ``idx & 31``; the output is
    the packed (B, m)-bit layer output."""
    mapping_idx = mapping_idx.long()
    sel = select_packed_bits(packed.words, mapping_idx >> 5,
                             mapping_idx & 31)
    out = _read_tables(tables_bin, lut_addresses(sel))
    return PackedBits.pack(out)


__all__ = [
    "LUTLayerSpec", "binarize_tables", "finalize_mapping", "first_max_index",
    "init_lut_layer", "lut_eval_hard", "lut_eval_hard_packed",
    "lut_layer_apply", "lut_layer_apply_stopgrad",
]
