"""Launch wrappers of the two LUT-layer CUDA kernels (``csrc/lut_eval.cu``):
``lut_eval`` (float32 bits, multilinear table evaluation) and
``lut_eval_packed`` (packed words), the counterparts of the reference's
Pallas kernels of the same names.

``lut_eval_packed`` stages its layer once per CUDA block in shared memory
and lets a warp's 32 lanes be 32 samples, so every read of the layer is a
broadcast (``csrc/lut_eval.cu``); a launch's layout comes from
:func:`plan_lut_eval_packed` and :func:`last_launch` reports it.
``lut_eval`` stages tiles of 16 rows and lets a warp's lanes be LUTs, 8
rows a thread, each table entry loaded once for 8 rows; its layout comes
from :func:`plan_lut_eval` and :func:`last_float_launch` reports it.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .._launch import (I, LaunchCounts, P, align16, bind, device_type,
                       expect, launch, sm_count)
from .ref import lut_eval_packed_plain, lut_eval_plain

LIBRARY = "lut_eval"
#: threads per block of the packed rows kernel and of both float kernels
#: (== kThreads in the source): 8 warps.
THREADS = 256
#: samples of a tile of ``lut_eval_packed``: a warp's lanes, one each.
TILE_ROWS = 32
#: dynamic shared memory one block may use on an H100.
MAX_SMEM_BYTES = 232_448
#: rows one block of the float rows kernel stages (== kRows in the
#: source).
FLOAT_ROWS = 8
#: rows of a tile of the float tile kernel (== kFloatTileRows).
FLOAT_TILE_ROWS = 16
#: LUTs of a pass of the float tile kernel (== kPassLuts): 4 warps' lanes.
PASS_LUTS = 128
#: widest fan-in of the float tiles and rows kernels (== kMaxFanIn): 2^8
#: corners; wider LUTs take the wide kernel (:func:`plan_lut_eval`).
TILE_FAN_IN = 8
#: widest fan-in ``lut_eval`` takes (== kWideMaxFanIn, the port's
#: ``fused.ref.MAX_FAN_IN``): 2^16 corners.
MAX_FAN_IN = 16
#: rows a thread of the float wide kernel evaluates (== kWideRows).
WIDE_ROWS = 4
_COUNTS = LaunchCounts("lut_eval", "lut_eval_packed")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"lut_eval_launch": [P, I, I, P, P, I, I, P, I, I, I, I, P,
                                   P],
               "lut_eval_rows_launch": [P, I, I, P, P, I, I, I, P, P],
               "lut_eval_wide_launch": [P, I, I, P, P, I, I, P, P],
               "lut_eval_packed_launch": [P, I, I, P, P, P, I, I, I, P, I,
                                          I, I, I, P, P],
               "lut_eval_packed_rows_launch": [P, I, I, P, P, P, I, I, I, P,
                                               I, P]}
#: the latest ``lut_eval_packed`` (see :func:`last_launch`)
_LAST: dict = {}
_LAUNCH_INFO = ("walkers", "blocks_per_sm")
#: what the C entry found at the latest ``lut_eval`` tiles launch
_FLOAT_INFO = (ctypes.c_int * len(_LAUNCH_INFO))()
#: the latest ``lut_eval`` plan (see :func:`last_float_launch`)
_LAST_FLOAT: list = [None]


def last_launch() -> dict:
    """The latest ``lut_eval_packed`` launch of this process: its
    :class:`PackedPlan` fields and, on the ``"tiles"`` path, ``walkers``
    (blocks that walk one slice's tiles) and ``blocks_per_sm`` as the
    launch found them."""
    return dict(_LAST)


def last_float_launch() -> dict:
    """The latest ``lut_eval`` launch of this process: its
    :class:`FloatPlan` fields and, on the ``"tiles"`` path, ``walkers``
    and ``blocks_per_sm`` as the launch found them; empty before the
    first launch."""
    plan = _LAST_FLOAT[0]
    if plan is None:
        return {}
    out = dataclasses.asdict(plan)
    if plan.path == "tiles":
        out.update(zip(_LAUNCH_INFO, _FLOAT_INFO))
    return out


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """How ``lut_eval_packed`` lays out one launch.

    ``path`` is ``"tiles"`` (tiles of 32 samples, one a lane, the layer's
    output words cut into ``slices`` slices of ``slice_words`` words, each
    staged once per block), ``"rows"`` (the port's first packed kernel,
    one warp a sample, kept for input rows too wide for a tile) or
    ``"global"`` (the same kernel reading each row from global memory,
    for rows too wide for its 8 warps' rows in a block).
    """

    path: str
    slices: int
    slice_words: int
    smem_bytes: int


def _tiles_smem_bytes(W_in: int, n: int, ws: int) -> int:
    """Shared memory of a ``lut_eval_packed`` block (packed_tiles_layout
    in the source): ``ws`` words of LUTs' wires (16 bits each) and tables,
    the output tile and two activation buffers of a tile."""
    tw = (2 ** n + 31) // 32
    return (align16(ws * 32 * n * 2) + align16(ws * 32 * tw * 4)
            + align16(ws * (TILE_ROWS + 1) * 4) + 2 * W_in * TILE_ROWS * 4)


def plan_lut_eval_packed(B: int, W_in: int, m: int, n: int,
                         sms: int) -> PackedPlan:
    """The layout of a ``lut_eval_packed`` launch of B >= 1 samples on a
    card of ``sms`` SMs; raises ``ValueError`` where no block fits.

    The m/32 output words are cut into slices as wide as fit a block's
    shared memory beside two tiles of 32 samples' input words; with fewer
    tiles than SMs, narrower, until tiles x slices fill the card.  Where
    those two tiles take more than half a block (W_in > 454 words: each
    slice would stage them again for a sliver of the layer), or not even
    one word of LUTs fits beside them (fan-in 16), the rows kernel
    takes the launch: rows of up to 7264 words staged, as before; wider
    ones read from global memory (``"global"``).
    """
    W_out = max(1, m // 32)       # m = 0: the wrapper launches nothing
    if _tiles_smem_bytes(W_in, n, 0) > MAX_SMEM_BYTES // 2 or \
            _tiles_smem_bytes(W_in, n, 1) > MAX_SMEM_BYTES:
        smem = THREADS // 32 * W_in * 4
        if smem > MAX_SMEM_BYTES:
            return PackedPlan("global", 1, W_out, 0)
        return PackedPlan("rows", 1, W_out, smem)
    lo, hi = 1, W_out + 1    # fits(lo); hi does not, or is past W_out
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _tiles_smem_bytes(W_in, n, mid) <= MAX_SMEM_BYTES:
            lo = mid
        else:
            hi = mid
    tiles = -(-B // TILE_ROWS)
    slices = max(-(-W_out // lo),
                 min(W_out, max(1, (sms + tiles // 2) // tiles)))
    ws = -(-W_out // slices)
    return PackedPlan("tiles", -(-W_out // ws), ws,
                      _tiles_smem_bytes(W_in, n, ws))


@dataclasses.dataclass(frozen=True)
class FloatPlan:
    """How ``lut_eval`` lays out one launch.

    ``path`` is ``"tiles"`` (tiles of ``rows`` = 16 rows, the layer's
    128-LUT passes cut into ``slices`` slices of ``slice_passes`` passes),
    ``"rows"`` (the port's first float kernel, ``rows`` <= 8 rows a
    block, kept for rows too wide for a tile) or ``"global"`` (the wide
    kernel: fan-in above 8 or rows past the rows kernel's, ``rows`` =
    :data:`WIDE_ROWS` rows a thread read from global memory, no shared
    memory).
    """

    path: str
    slices: int
    slice_passes: int
    rows: int
    smem_bytes: int


def _float_tiles_smem_bytes(C: int) -> int:
    """Shared memory of a ``lut_eval`` tile block (float_tiles_bytes in
    the source): a tile of 16 rows of C floats, each padded to a multiple
    of 4."""
    return align16(FLOAT_TILE_ROWS * ((C + 3) // 4 * 4) * 4)


@functools.lru_cache(maxsize=256)
def plan_lut_eval(B: int, C: int, m: int, sms: int,
                  n: int = TILE_FAN_IN) -> FloatPlan:
    """The layout of a ``lut_eval`` launch of B >= 1 rows of C bits and m
    LUTs of fan-in n, on a card of ``sms`` SMs, for every shape.

    Up to fan-in 8, where a tile of 16 rows fits a block (C <= 3632), the
    tile kernel takes it, the ceil(m/128) passes cut into slices only
    below 132 tiles, until tiles x slices fill the card.  Wider rows take
    the rows kernel: as many rows a block as fit, up to 8, so rows of up
    to 58,112 bits, as before.  Wider rows still, and fan-in 9 to 16, take
    the wide kernel (``"global"``).  Cached: a wrapper call looks its plan
    up, it does not plan again.
    """
    smem = _float_tiles_smem_bytes(C)
    passes = -(-max(m, 1) // PASS_LUTS)    # m = 0: nothing is launched
    rows = min(FLOAT_ROWS, MAX_SMEM_BYTES // (4 * max(C, 1)))
    if n > TILE_FAN_IN or (smem > MAX_SMEM_BYTES and rows < 1):
        return FloatPlan("global", 1, passes, WIDE_ROWS, 0)
    if smem > MAX_SMEM_BYTES:
        return FloatPlan("rows", 1, passes, rows, rows * C * 4)
    tiles = -(-B // FLOAT_TILE_ROWS)
    slices = min(passes, max(1, (sms + tiles // 2) // tiles))
    per = -(-passes // slices)
    return FloatPlan("tiles", -(-passes // per), per, FLOAT_TILE_ROWS, smem)


def lut_eval(bits: torch.Tensor, mapping: torch.Tensor,
             tables_t: torch.Tensor) -> torch.Tensor:
    """One LUT layer on float32 bits: the multilinear table evaluation.

    bits (B, C) float32; mapping (m, n) int32 wire indices in [0, C) (the
    op checks them; the kernel does not); tables_t (2^n, m) float32, the
    tables corner-major (``tables.T``), so that neighbouring threads read
    neighbouring LUTs.  1 <= n <= :data:`MAX_FAN_IN`; any C
    (:func:`plan_lut_eval`).  Returns (B, m) float32:
    ``ref.lut_eval_plain(bits, mapping, tables_t.T)``.
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
    sms = sm_count(dev)
    plan = plan_lut_eval(max(B, 1), C, m, sms, n)
    out = torch.empty((B, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    _LAST_FLOAT[0] = None
    ptrs = (bits.data_ptr(), B, C, mapping.data_ptr(), tables_t.data_ptr(),
            m, n)
    if plan.path == "rows":
        launch(lib, LIBRARY, "lut_eval", dev,
               lambda stream: lib.lut_eval_rows_launch(
                   *ptrs, plan.rows, out.data_ptr(), stream), _COUNTS)
    elif plan.path == "global":
        launch(lib, LIBRARY, "lut_eval", dev,
               lambda stream: lib.lut_eval_wide_launch(
                   *ptrs, out.data_ptr(), stream), _COUNTS)
    else:
        launch(lib, LIBRARY, "lut_eval", dev,
               lambda stream: lib.lut_eval_launch(
                   *ptrs, out.data_ptr(), plan.slices, plan.slice_passes,
                   sms, plan.smem_bytes, _FLOAT_INFO, stream), _COUNTS)
    _LAST_FLOAT[0] = plan
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
    takes either carrier and returns int64 carriers.  Any W_in
    (:func:`plan_lut_eval_packed`).
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
    sms = sm_count(dev)
    plan = plan_lut_eval_packed(max(B, 1), W_in, m, n, sms)
    out = torch.empty((B, m // 32), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    _LAST.clear()
    _LAST.update(dataclasses.asdict(plan))
    ptrs = (words.data_ptr(), B, W_in, word_idx.data_ptr(),
            bit_off.data_ptr(), table_words.data_ptr(), m, n,
            table_words.shape[1], out.data_ptr())
    if plan.path != "tiles":
        staged = int(plan.path == "rows")
        launch(lib, LIBRARY, "lut_eval_packed", dev,
               lambda stream: lib.lut_eval_packed_rows_launch(
                   *ptrs, staged, stream), _COUNTS)
        return out
    info = (ctypes.c_int * len(_LAUNCH_INFO))()
    launch(lib, LIBRARY, "lut_eval_packed", dev,
           lambda stream: lib.lut_eval_packed_launch(
               *ptrs, plan.slices, plan.slice_words, sms, plan.smem_bytes,
               info, stream), _COUNTS)
    _LAST.update(zip(_LAUNCH_INFO, info))
    return out


__all__ = ["FLOAT_ROWS", "FLOAT_TILE_ROWS", "FloatPlan", "MAX_FAN_IN",
           "PASS_LUTS", "PackedPlan", "TILE_FAN_IN", "WIDE_ROWS",
           "last_float_launch", "last_launch", "launch_counts", "lut_eval",
           "lut_eval_packed", "plan_lut_eval", "plan_lut_eval_packed",
           "reset_launch_counts"]
