"""Launch wrappers of the two thermometer-encode CUDA kernels
(``csrc/thermometer.cu``): ``thermometer_encode`` (float32 bits) and
``thermometer_encode_packed`` (packed words), the counterparts of the
reference's Pallas kernels of the same names.

``thermometer_encode_packed`` walks tiles of 32 samples, one a CUDA lane,
with its slice of the thresholds staged once per block
(``csrc/thermometer.cu``); a launch's layout comes from
:func:`plan_thermometer_encode_packed` and :func:`last_launch` reports
it.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...core.bitpack import words_for_bits
from .._launch import (I, LaunchCounts, P, align16, bind, device_type,
                       expect, launch, sm_count)
from .ref import thermometer_packed_plain, thermometer_plain

LIBRARY = "thermometer"
#: samples of a tile of ``thermometer_encode_packed``: a warp's lanes.
TILE_ROWS = 32
#: dynamic shared memory one block may use on an H100.
MAX_SMEM_BYTES = 232_448
_COUNTS = LaunchCounts("thermometer_encode", "thermometer_encode_packed")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"thermometer_encode_launch": [P, P, I, I, I, P, P],
               "thermometer_encode_packed_launch": [P, P, I, I, I, P, I, I,
                                                    I, I, P, P],
               "thermometer_encode_packed_rows_launch": [P, P, I, I, I, P,
                                                         P]}
_LAUNCH_INFO = ("walkers", "blocks_per_sm")
#: what the C entry found at the latest tiles launch, by _LAUNCH_INFO
_INFO = (ctypes.c_int * len(_LAUNCH_INFO))()
#: the latest ``thermometer_encode_packed`` plan (see :func:`last_launch`)
_LAST: list = [None]


def last_launch() -> dict:
    """The latest ``thermometer_encode_packed`` launch of this process: its
    :class:`EncodePlan` fields and, on the ``"tiles"`` path, ``walkers``
    (blocks that walk one slice's tiles) and ``blocks_per_sm`` as the
    launch found them; empty before the first launch."""
    plan = _LAST[0]
    if plan is None:
        return {}
    out = dataclasses.asdict(plan)
    if plan.path == "tiles":
        out.update(zip(_LAUNCH_INFO, _INFO))
    return out


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """How ``thermometer_encode_packed`` lays out one launch.

    ``path`` is ``"tiles"`` (tiles of 32 samples, one a lane, the output
    words cut into ``slices`` slices of ``slice_words`` words, each
    slice's thresholds staged once per block) or ``"rows"`` (the port's
    first packed encode, one warp a sample's 32 words, kept for features
    too many for a tile).
    """

    path: str
    slices: int
    slice_words: int
    smem_bytes: int


def _tiles_smem_bytes(F: int, ws: int) -> int:
    """Shared memory of a ``thermometer_encode_packed`` block
    (encode_tiles_layout in the source): ``ws`` words of thresholds, the
    output tile and two feature buffers of a tile."""
    return (align16(ws * 32 * 4) + align16(ws * (TILE_ROWS + 1) * 4)
            + 2 * F * TILE_ROWS * 4)


@functools.lru_cache(maxsize=256)
def plan_thermometer_encode_packed(B: int, F: int, T: int,
                                   sms: int) -> EncodePlan:
    """The layout of a ``thermometer_encode_packed`` launch of B >= 1
    samples on a card of ``sms`` SMs.

    The ceil(F*T/32) output words are cut into slices whose thresholds fit
    a block's shared memory beside two tiles of 32 samples' features;
    with fewer tiles than SMs, narrower, until tiles x slices fill the
    card.  Where those two tiles take more than half a block (F > 454), or
    the slices would outnumber a grid's 65535 rows, or F*T does not fit a
    32-bit int, the rows kernel takes the launch (any F, T, B, as before).
    Cached: a wrapper call looks its plan up, it does not plan again.
    """
    W = max(1, words_for_bits(F * T))
    rows = EncodePlan("rows", 1, W, 0)
    if _tiles_smem_bytes(F, 0) > MAX_SMEM_BYTES // 2 or F * T >= 2 ** 31:
        return rows
    lo, hi = 1, W + 1    # fits(lo); hi does not, or is past W
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _tiles_smem_bytes(F, mid) <= MAX_SMEM_BYTES:
            lo = mid
        else:
            hi = mid
    tiles = -(-B // TILE_ROWS)
    slices = max(-(-W // lo), min(W, max(1, (sms + tiles // 2) // tiles)))
    ws = -(-W // slices)
    slices = -(-W // ws)
    if slices > 65535:
        return rows
    return EncodePlan("tiles", slices, ws, _tiles_smem_bytes(F, ws))


def _check(x: torch.Tensor, thresholds: torch.Tensor):
    """(B, F, T) of valid operands on ``x``'s device; raises otherwise."""
    dev = x.device
    expect(x, "x", torch.float32, 2, dev)
    expect(thresholds, "thresholds", torch.float32, 2, dev)
    B, F = x.shape
    F_th, T = thresholds.shape
    if F_th != F:
        raise ValueError(f"x has {F} features, thresholds {F_th}")
    return B, F, T


def thermometer_encode(x: torch.Tensor,
                       thresholds: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32, thresholds (F, T) float32 -> (B, F, T) float32:
    1.0 where ``x[b, f] > th[f, t]``, else 0.0 (NaN compares false).
    """
    if device_type(x, "thermometer_encode") == "cpu":
        return thermometer_plain(x, thresholds)
    B, F, T = _check(x, thresholds)
    out = torch.empty((B, F, T), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "thermometer_encode", x.device,
           lambda stream: lib.thermometer_encode_launch(
               x.data_ptr(), thresholds.data_ptr(), B, F, T, out.data_ptr(),
               stream), _COUNTS)
    return out


def thermometer_encode_packed(x: torch.Tensor,
                              thresholds: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32, thresholds (F, T) float32 -> (B, ceil(F*T/32))
    words: bit ``f*T + t`` is ``x[b, f] > th[f, t]``, LSB-first, zero pad
    bits.  int32 bit patterns on CUDA, int64 carriers on the CPU.
    """
    if device_type(x, "thermometer_encode_packed") == "cpu":
        return thermometer_packed_plain(x, thresholds)
    B, F, T = _check(x, thresholds)
    dev = x.device
    out = torch.empty((B, words_for_bits(F * T)), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    sms = sm_count(dev)
    plan = plan_thermometer_encode_packed(B, F, T, sms)
    lib = bind(LIBRARY, _SIGNATURES)
    _LAST[0] = None
    ptrs = (x.data_ptr(), thresholds.data_ptr(), B, F, T, out.data_ptr())
    if plan.path == "rows":
        launch(lib, LIBRARY, "thermometer_encode_packed", dev,
               lambda stream: lib.thermometer_encode_packed_rows_launch(
                   *ptrs, stream), _COUNTS)
    else:
        launch(lib, LIBRARY, "thermometer_encode_packed", dev,
               lambda stream: lib.thermometer_encode_packed_launch(
                   *ptrs, plan.slices, plan.slice_words, sms,
                   plan.smem_bytes, _INFO, stream), _COUNTS)
    _LAST[0] = plan
    return out


__all__ = ["EncodePlan", "last_launch", "launch_counts",
           "plan_thermometer_encode_packed", "reset_launch_counts",
           "thermometer_encode", "thermometer_encode_packed"]
