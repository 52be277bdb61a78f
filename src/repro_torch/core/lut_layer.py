"""DWN LUT layer: the hard (frozen, hardware-semantics) paths.

The PyTorch counterpart of the inference half of ``repro.core.lut_layer``.
Each of the ``m`` LUTs reads ``n`` candidate bits chosen by a learnable
mapping (an (m, n, C) score matrix, frozen to its first argmax) and
addresses a binary truth table of ``2^n`` entries with them; bit ``i`` of
the address is the ``i``-th selected bit.  Training (the EFD backward and
the softmax straight-through mapping) is not ported yet.
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


def first_max_index(x: torch.Tensor,
                    vmax: torch.Tensor | None = None) -> torch.Tensor:
    """First index of the row maximum over the last axis (ties go to the
    lowest index), as int32."""
    if vmax is None:
        vmax = x.amax(dim=-1, keepdim=True)
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    out = torch.where(x == vmax, idx, x.shape[-1]).amin(dim=-1)
    return out.to(torch.int32)


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
]
