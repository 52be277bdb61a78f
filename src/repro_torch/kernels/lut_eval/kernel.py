"""Launch wrappers of the two LUT-layer CUDA kernels (``csrc/lut_eval.cu``):
``lut_eval`` (float32 bits, multilinear table evaluation) and
``lut_eval_packed`` (packed words), the counterparts of the reference's
Pallas kernels of the same names.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import torch

from .._launch import I, LaunchCounts, P, bind, device_type, expect, launch
from .ref import lut_eval_packed_plain, lut_eval_plain

LIBRARY = "lut_eval"
#: threads per block (== kThreads in the source): 8 warps, one row each.
THREADS = 256
#: dynamic shared memory one block may use on an H100.
MAX_SMEM_BYTES = 232_448
#: rows one block of the float kernel stages (== kRows in the source).
FLOAT_ROWS = 8
#: widest fan-in the float kernel takes (== kMaxFanIn): 2^8 corners.
MAX_FAN_IN = 8
_COUNTS = LaunchCounts("lut_eval", "lut_eval_packed")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"lut_eval_launch": [P, I, I, P, P, I, I, I, P, P],
               "lut_eval_packed_launch": [P, I, I, P, P, P, I, I, I, P, P]}


def lut_eval(bits: torch.Tensor, mapping: torch.Tensor,
             tables_t: torch.Tensor) -> torch.Tensor:
    """One LUT layer on float32 bits: the multilinear table evaluation.

    bits (B, C) float32; mapping (m, n) int32 wire indices in [0, C) (the
    op checks them; the kernel does not); tables_t (2^n, m) float32, the
    tables corner-major (``tables.T``), so that neighbouring threads read
    neighbouring LUTs.  1 <= n <= :data:`MAX_FAN_IN`.  Returns (B, m)
    float32: ``ref.lut_eval_plain(bits, mapping, tables_t.T)``.
    """
    if device_type(bits, "lut_eval") == "cpu":
        return lut_eval_plain(bits, mapping, tables_t.T)
    dev = bits.device
    expect(bits, "bits", torch.float32, 2, dev)
    expect(mapping, "mapping", torch.int32, 2, dev)
    expect(tables_t, "tables_t", torch.float32, 2, dev)
    B, C = bits.shape
    m, n = mapping.shape
    if not 1 <= n <= MAX_FAN_IN:
        raise ValueError(f"lut_eval takes a fan-in of 1 to {MAX_FAN_IN}, "
                         f"got {n}")
    if tuple(tables_t.shape) != (2 ** n, m):
        raise ValueError(f"tables_t has shape {tuple(tables_t.shape)}; "
                         f"expected {(2 ** n, m)} (corner-major)")
    rows = min(FLOAT_ROWS, MAX_SMEM_BYTES // (4 * max(C, 1)))
    if rows < 1:
        raise ValueError(f"lut_eval: a row of {C} bits does not fit in "
                         f"the card's {MAX_SMEM_BYTES} bytes of shared "
                         f"memory")
    out = torch.empty((B, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "lut_eval", dev,
           lambda stream: lib.lut_eval_launch(
               bits.data_ptr(), B, C, mapping.data_ptr(),
               tables_t.data_ptr(), m, n, rows, out.data_ptr(), stream),
           _COUNTS)
    return out


def lut_eval_packed(words: torch.Tensor, word_idx: torch.Tensor,
                    bit_off: torch.Tensor,
                    table_words: torch.Tensor) -> torch.Tensor:
    """One word-addressed LUT layer on packed words.

    words (B, W_in); word_idx / bit_off (m, n) int32, each wire's word and
    bit position, with ``word_idx < W_in`` and ``bit_off < 32`` (the op
    checks the wires); table_words (m, ceil(2^n/32)) int32 truth-table
    words; m a multiple of 32.  Returns (B, m/32) words.  On CUDA every
    word tensor is an int32 bit pattern; on the CPU the plain version
    takes either carrier and returns int64 carriers.
    """
    if device_type(words, "lut_eval_packed") == "cpu":
        return lut_eval_packed_plain(words, word_idx, bit_off, table_words)
    dev = words.device
    expect(words, "words", torch.int32, 2, dev)
    expect(word_idx, "word_idx", torch.int32, 2, dev)
    expect(bit_off, "bit_off", torch.int32, 2, dev)
    expect(table_words, "table_words", torch.int32, 2, dev)
    B, W_in = words.shape
    m, n = word_idx.shape
    if m % 32 != 0 or bit_off.shape != word_idx.shape or \
            table_words.shape != (m, (2 ** n + 31) // 32):
        raise ValueError(
            f"layer operands disagree: word_idx {tuple(word_idx.shape)}, "
            f"bit_off {tuple(bit_off.shape)}, table_words "
            f"{tuple(table_words.shape)} (m must be a multiple of 32 and "
            f"each LUT needs ceil(2^n/32) table words)")
    smem = THREADS // 32 * W_in * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"lut_eval_packed: {smem} bytes of shared memory "
                         f"per block exceed the card's {MAX_SMEM_BYTES}")
    out = torch.empty((B, m // 32), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "lut_eval_packed", dev,
           lambda stream: lib.lut_eval_packed_launch(
               words.data_ptr(), B, W_in, word_idx.data_ptr(),
               bit_off.data_ptr(), table_words.data_ptr(), m, n,
               table_words.shape[1], out.data_ptr(), stream), _COUNTS)
    return out


__all__ = ["FLOAT_ROWS", "MAX_FAN_IN", "launch_counts", "lut_eval",
           "lut_eval_packed", "reset_launch_counts"]
