"""Plain PyTorch versions of the two LUT-layer kernels (float and
packed), and the wiring helpers they share."""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from ...core.bitpack import (from_word_pattern, lut_addresses, pack_bits,
                             select_packed_bits)


def packed_wire_indices(mapping: torch.Tensor):
    """(m, n) logical bit indices -> (word_idx, bit_off) int32 per the
    bitpack convention: word ``idx >> 5``, LSB-first position
    ``idx & 31``."""
    mapping = torch.as_tensor(mapping).to(torch.int32)
    return mapping >> 5, mapping & 31


#: rows of ``bits`` the plain float version takes at once: at lg width
#: each intermediate is then (256, 2400, 32) float32, 79 MB.
PLAIN_CHUNK_ROWS = 256


def check_wires(mapping: torch.Tensor, num_candidates: int) -> None:
    """Raise ``ValueError`` unless every wire index lies in
    [0, num_candidates).  One reduction and a host sync on the card."""
    if mapping.numel() and (int(mapping.min()) < 0
                            or int(mapping.max()) >= num_candidates):
        raise ValueError(f"mapping indices must lie in [0, "
                         f"{num_candidates})")


def selection_onehot(mapping: torch.Tensor,
                     num_candidates: int) -> torch.Tensor:
    """(m, n) wire indices -> (C, m*n) float32 one-hot selection matrix:
    column ``l*n + i`` holds a single 1, in row ``mapping[l, i]`` (the
    reference's wiring recast as a dense matrix).  ``bits @ sel`` equals
    the gather ``bits[:, mapping.reshape(-1)]`` exactly for finite bits.
    For tests and readers: no path on the card builds it."""
    flat = torch.as_tensor(mapping).reshape(-1).long()
    return nnf.one_hot(flat, num_candidates).to(torch.float32).T


def lut_eval_plain(bits: torch.Tensor, mapping: torch.Tensor,
                   tables: torch.Tensor) -> torch.Tensor:
    """One LUT layer on float bits, as the multilinear function of them.

    bits (B, C) float32, mapping (m, n) int wire indices in [0, C), tables
    (m, 2^n) float.  With ``s_i = bits[b, mapping[l, i]]``,
    ``out[b, l] = sum_a tables[l, a] * prod_i (s_i if bit i of a else
    1 - s_i)``, evaluated as a tree of lerps ``lo + s_i * (hi - lo)`` over
    input 0 first, then 1, ... (the CUDA kernel's order and rounding for
    bits in {0,1}).  For bits in {0,1} that is ``tables[l, addr]``, exactly
    for {0,1} tables and within an ulp (``lo + (hi - lo)``) for float ones;
    for bits in (0, 1) it interpolates.  Any fan-in; rows go in chunks of
    :data:`PLAIN_CHUNK_ROWS`.  Returns (B, m) float32.
    """
    m, n = mapping.shape
    if tuple(tables.shape) != (m, 2 ** n):
        raise ValueError(f"tables have shape {tuple(tables.shape)}; "
                         f"expected {(m, 2 ** n)}")
    tables = tables.to(torch.float32)
    wires = mapping.reshape(-1).long()
    out = torch.empty((bits.shape[0], m), dtype=torch.float32,
                      device=bits.device)
    for i in range(0, bits.shape[0], PLAIN_CHUNK_ROWS):
        s = bits[i:i + PLAIN_CHUNK_ROWS][:, wires].reshape(-1, m, n)
        v = tables
        for k in range(n):
            v = v.reshape(*v.shape[:-1], -1, 2)
            sk = s[:, :, k, None]
            lo = v[..., 0]
            v = lo + sk * (v[..., 1] - lo)
        out[i:i + PLAIN_CHUNK_ROWS] = v.reshape(-1, m)
    return out


def table_bits(table_words: torch.Tensor,
               addr: torch.Tensor) -> torch.Tensor:
    """Table entry ``addr`` of each LUT: table_words (m, tw) words (entry
    ``a`` at bit ``a & 31`` of word ``a >> 5``), addr (B, m) -> (B, m)
    int64 {0,1}."""
    lut = torch.arange(table_words.shape[0], device=addr.device)
    w = from_word_pattern(table_words)[lut[None, :], addr >> 5]
    return (w >> (addr & 31)) & 1


def lut_eval_packed_plain(words: torch.Tensor, word_idx: torch.Tensor,
                          bit_off: torch.Tensor,
                          table_words: torch.Tensor) -> torch.Tensor:
    """One word-addressed LUT layer on packed words.

    words (B, W_in) in either carrier (int32 bit patterns or int64 values
    in [0, 2^32)); word_idx / bit_off (m, n) int — wire k of LUT l reads
    bit ``bit_off[l, k]`` of word ``word_idx[l, k]`` and is bit k of the
    address; table_words (m, ceil(2^n/32)) words.  Returns (B, ceil(m/32))
    int64 words of the m output bits, zero pad bits.
    """
    sel = select_packed_bits(from_word_pattern(words), word_idx, bit_off)
    return pack_bits(table_bits(table_words, lut_addresses(sel)))


__all__ = ["PLAIN_CHUNK_ROWS", "check_wires", "lut_eval_packed_plain",
           "lut_eval_plain", "packed_wire_indices", "selection_onehot",
           "table_bits"]
