"""Packed-bitplane representation: 32 logical bits per 32-bit word.

The PyTorch counterpart of ``repro.core.bitpack`` and the single source of
truth for the port's packed bit-format:

Bit-format convention
---------------------
* A logical bit-vector of length ``N`` packs along its **last axis** into
  ``W = ceil(N / 32)`` words: logical bit ``i`` lives in word ``i >> 5`` at
  bit position ``i & 31`` (**LSB-first** within a word).
* When ``N % 32 != 0`` the trailing pad bits of the last word are **zero**;
  every producer must maintain this invariant (popcounts rely on it).
* Thermometer outputs pack the *flattened* ``(F*T,)`` bit order — feature-
  major, bit ``f*T + t`` — so LUT mapping indices address packed words
  directly as ``(idx >> 5, idx & 31)``.

Word dtypes
-----------
PyTorch's ``uint32`` lacks shifts and ``index_select`` on the CPU, so the
plain tensor code here carries each word as an **int64 holding a value in
[0, 2^32)** and masks after every multiply.  The CUDA kernels take the same
words as an int32 *bit pattern* (:func:`to_word_pattern`), which they read
as ``uint32_t``.  Words become numpy ``uint32`` only at the numpy boundary
(:func:`words_to_numpy`).  The numpy twins (``*_np``) are copies of the
reference package's, kept here so the port imports nothing of it.

A :class:`PackedBits` says by its words' dtype which carrier it holds.  The
staged packed ops (``kernels/{thermometer,lut_eval,popcount}/ops.py``)
carry int32 bit patterns on CUDA, so one stage's output feeds the next
kernel with no conversion, and int64 carriers on the CPU
(:func:`device_words`).  :func:`unpack_bits`, :func:`words_to_numpy`,
:func:`from_word_pattern` and the kernels' plain versions take either.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

WORD_BITS = 32
_WORD_MASK = 0xFFFFFFFF

# SWAR popcount constants (Hacker's Delight fig. 5-2).
_M1, _M2, _M4, _H01 = 0x55555555, 0x33333333, 0x0F0F0F0F, 0x01010101


def words_for_bits(num_bits: int) -> int:
    """ceil(num_bits / 32): words holding a num_bits-long vector."""
    return (num_bits + WORD_BITS - 1) // WORD_BITS


def _bit_weights(device) -> torch.Tensor:
    return torch.ones((), dtype=torch.int64, device=device) << torch.arange(
        WORD_BITS, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack {0,1} values (..., N) -> (..., ceil(N/32)) int64 words, LSB-first.

    Any non-zero entry is a set bit.  Words hold values in [0, 2^32).
    """
    n = bits.shape[-1]
    w = words_for_bits(n)
    b = (bits != 0).to(torch.int64)
    b = torch.nn.functional.pad(b, (0, w * WORD_BITS - n))
    b = b.reshape(*bits.shape[:-1], w, WORD_BITS)
    return (b * _bit_weights(bits.device)).sum(dim=-1)


def unpack_bits(words: torch.Tensor, num_bits: int,
                dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) words -> (..., num_bits)."""
    words = words.to(torch.int64) & _WORD_MASK
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    b = (words[..., :, None] >> shifts) & 1
    b = b.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return b[..., :num_bits].to(dtype)


def to_word_pattern(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same bit pattern
    (what the CUDA kernels read as ``uint32_t``)."""
    words = words.to(torch.int64) & _WORD_MASK
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def from_word_pattern(words: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 words in [0, 2^32) (inverse of
    :func:`to_word_pattern`)."""
    return words.to(torch.int64) & _WORD_MASK


def device_words(words: torch.Tensor) -> torch.Tensor:
    """``words`` in their device's carrier: int32 bit patterns on CUDA (what
    the kernels read), int64 values in [0, 2^32) elsewhere; returned as
    they are when they already have it."""
    if words.device.type == "cuda":
        return words if words.dtype == torch.int32 else to_word_pattern(words)
    return words if words.dtype == torch.int64 else from_word_pattern(words)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Words (either carrier) -> numpy uint32, the reference's format."""
    return from_word_pattern(words).cpu().numpy().astype(np.uint32)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`pack_bits` (uint32 words)."""
    bits = np.asarray(bits)
    n = bits.shape[-1]
    w = words_for_bits(n)
    pad = [(0, 0)] * (bits.ndim - 1) + [(0, w * WORD_BITS - n)]
    b = np.pad((bits != 0).astype(np.uint32), pad)
    b = b.reshape(*bits.shape[:-1], w, WORD_BITS)
    weights = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32))
    return np.sum(b * weights, axis=-1, dtype=np.uint32)


def unpack_bits_np(words: np.ndarray, num_bits: int,
                   dtype=np.float32) -> np.ndarray:
    """NumPy twin of :func:`unpack_bits`."""
    words = np.asarray(words, np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    b = (words[..., :, None] >> shifts) & np.uint32(1)
    b = b.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return b[..., :num_bits].astype(dtype)


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """Per-word popcount (SWAR) of int64 words in [0, 2^32).

    Returns int64 set-bit counts in [0, 32], same shape.  The multiply is
    masked back to 32 bits, as uint32 arithmetic would wrap.
    """
    v = v.to(torch.int64) & _WORD_MASK
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * _H01) & _WORD_MASK) >> 24


def popcount_u32_np(v: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`popcount_u32`."""
    v = np.asarray(v, np.uint32)
    v = v - ((v >> np.uint32(1)) & np.uint32(_M1))
    v = (v & np.uint32(_M2)) + ((v >> np.uint32(2)) & np.uint32(_M2))
    v = (v + (v >> np.uint32(4))) & np.uint32(_M4)
    return (v * np.uint32(_H01)) >> np.uint32(24)


def select_packed_bits(words: torch.Tensor, word_idx: torch.Tensor,
                       bit_off: torch.Tensor) -> torch.Tensor:
    """Read mapped bits out of packed words with shift/AND.

    words (..., W) int64; word_idx / bit_off (m, n) int — the wire's word
    index ``idx >> 5`` and LSB-first position ``idx & 31``.
    Returns (..., m, n) int64 {0,1}.
    """
    m, n = word_idx.shape
    g = words[..., word_idx.reshape(-1).long()]              # (..., m*n)
    sel = (g >> bit_off.reshape(-1).long()) & 1
    return sel.reshape(*words.shape[:-1], m, n)


def lut_addresses(sel: torch.Tensor) -> torch.Tensor:
    """(..., m, n) {0,1} -> (..., m) int64 LUT address; bit i has weight
    2^i."""
    n = sel.shape[-1]
    addr = torch.zeros(sel.shape[:-1], dtype=torch.int64, device=sel.device)
    for i in range(n):
        addr = addr | (sel[..., i].to(torch.int64) << i)
    return addr


def masked_group_counts(words: torch.Tensor,
                        masks: torch.Tensor) -> torch.Tensor:
    """Masked SWAR popcount: words (..., W), masks (G, W), both int64 in
    [0, 2^32) -> (..., G) float32 per-group set-bit counts."""
    masked = words[..., None, :] & masks                     # (..., G, W)
    return popcount_u32(masked).sum(dim=-1).to(torch.float32)


def group_masks_np(num_bits: int, num_groups: int) -> np.ndarray:
    """(G, W) uint32 masks selecting each group's contiguous bit-range.

    Group ``g`` owns logical bits ``[g*gs, (g+1)*gs)`` with
    ``gs = num_bits // num_groups`` — the classifier's class groups.  Word
    boundaries need not align with group boundaries.
    """
    if num_bits % num_groups != 0:
        raise ValueError(f"{num_bits} bits do not split into {num_groups} "
                         f"equal groups")
    gs = num_bits // num_groups
    w = words_for_bits(num_bits)
    bit_of = np.arange(w * WORD_BITS)
    group_of = np.where(bit_of < num_bits, bit_of // gs, -1)
    masks = np.zeros((num_groups, w), np.uint32)
    weights = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32))
    for g in range(num_groups):
        sel = (group_of == g).reshape(w, WORD_BITS).astype(np.uint32)
        masks[g] = np.sum(sel * weights, axis=-1, dtype=np.uint32)
    return masks


@functools.lru_cache(maxsize=None)
def _group_masks_np_cached(num_bits: int, num_groups: int) -> np.ndarray:
    return group_masks_np(num_bits, num_groups)


def group_masks(num_bits: int, num_groups: int,
                device="cpu") -> torch.Tensor:
    """:func:`group_masks_np` as int64 words on ``device`` (the numpy build
    is memoized per (num_bits, num_groups))."""
    return torch.from_numpy(
        _group_masks_np_cached(num_bits, num_groups).astype(np.int64)).to(
            device)


@dataclasses.dataclass
class PackedBits:
    """A logical bit-vector in packed words (see module docstring).

    Attributes:
      words: (..., W) words, W = ceil(num_bits / 32), pad bits zero: int64
        values in [0, 2^32), or int32 bit patterns as the staged ops give
        on CUDA (see "Word dtypes" above).
      num_bits: logical bit count N.
    """

    words: torch.Tensor
    num_bits: int

    @classmethod
    def pack(cls, bits: torch.Tensor) -> "PackedBits":
        return cls(pack_bits(bits), bits.shape[-1])

    def unpack(self, dtype=torch.float32) -> torch.Tensor:
        return unpack_bits(self.words, self.num_bits, dtype)


__all__ = [
    "WORD_BITS", "words_for_bits", "pack_bits", "unpack_bits",
    "to_word_pattern", "from_word_pattern", "device_words",
    "words_to_numpy",
    "pack_bits_np", "unpack_bits_np", "popcount_u32", "popcount_u32_np",
    "select_packed_bits", "lut_addresses", "masked_group_counts",
    "group_masks_np", "group_masks", "PackedBits",
]
