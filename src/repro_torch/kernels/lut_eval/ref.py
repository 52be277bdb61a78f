"""Plain PyTorch version of the packed LUT-layer kernel."""

from __future__ import annotations

import torch

from ...core.bitpack import (from_word_pattern, lut_addresses, pack_bits,
                             select_packed_bits)


def packed_wire_indices(mapping: torch.Tensor):
    """(m, n) logical bit indices -> (word_idx, bit_off) int32 per the
    bitpack convention: word ``idx >> 5``, LSB-first position
    ``idx & 31``."""
    mapping = torch.as_tensor(mapping).to(torch.int32)
    return mapping >> 5, mapping & 31


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


__all__ = ["lut_eval_packed_plain", "packed_wire_indices", "table_bits"]
