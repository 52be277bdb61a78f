"""Launch wrappers of the two popcount and classify CUDA kernels
(``csrc/popcount.cu``): ``popcount_classify`` (group sums of float32 bits)
and ``popcount_classify_packed`` (masked popcounts of packed words), the
counterparts of the reference's Pallas kernels of the same names.

``popcount_classify_packed`` lets a warp's 32 lanes be 32 samples, a
block's tile, whose rows and the class masks it stages once in shared
memory (``csrc/popcount.cu``); a launch's path comes from
:func:`plan_popcount_classify_packed` and :func:`last_launch` reports it.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .._launch import (I, LaunchCounts, P, align16, bind, device_type,
                       expect, launch)
from .ref import (class_group, popcount_classify_packed_plain,
                  popcount_classify_plain)

LIBRARY = "popcount"
#: samples of a tile of ``popcount_classify_packed``: a warp's lanes.
TILE_ROWS = 32
#: most warps a tile's block splits its row over (== kMaxTileWarps).
MAX_TILE_WARPS = 8
#: fewest words of the row a warp of a tile takes, where the row has them:
#: each warp's sums cost a test of its classes and an add per class.
WARP_WORDS = 8
#: most classes the tile kernel takes (== kMaxClasses): a warp's classes
#: with a non-zero mask word are one 32-bit set.
MAX_CLASSES = 32
#: words a lane of the tile kernel holds in registers at once (== kChunk);
#: the masks are padded by as many words in shared memory.
CHUNK = 16
#: dynamic shared memory one block may use on an H100.
MAX_SMEM_BYTES = 232_448
_COUNTS = LaunchCounts("popcount_classify", "popcount_classify_packed")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"popcount_classify_launch": [P, I, I, I, P, P, P],
               "popcount_classify_packed_launch": [P, I, I, P, I, P, P, I,
                                                   I, P],
               "popcount_classify_packed_rows_launch": [P, I, I, P, I, P, P,
                                                        P]}
#: the latest ``popcount_classify_packed`` plan (see :func:`last_launch`)
_LAST: list = [None]


def last_launch() -> dict:
    """The latest ``popcount_classify_packed`` launch of this process: its
    :class:`PopcountPlan` fields; empty before the first launch."""
    plan = _LAST[0]
    return {} if plan is None else dataclasses.asdict(plan)


@dataclasses.dataclass(frozen=True)
class PopcountPlan:
    """How ``popcount_classify_packed`` lays out one launch.

    ``path`` is ``"tiles"`` (a block a tile of 32 samples, one a lane, its
    row's words split over ``warps`` warps) or ``"rows"`` (the port's
    first packed classify, one warp a sample, kept for rows too wide for
    a tile and for more than :data:`MAX_CLASSES` classes; ``warps`` is
    then 0).
    """

    path: str
    warps: int
    smem_bytes: int


def _tiles_smem_bytes(W: int, C: int) -> int:
    """Shared memory of a ``popcount_classify_packed`` block
    (popcount_tiles_layout in the source): the masks and a chunk of
    padding, 16-byte aligned, the tile's [C][32] counts and its 32 rows
    at an odd pitch."""
    return (align16((C * W + CHUNK) * 4) + C * TILE_ROWS * 4
            + TILE_ROWS * (W | 1) * 4)


@functools.lru_cache(maxsize=256)
def plan_popcount_classify_packed(W: int, C: int) -> PopcountPlan:
    """The layout of a ``popcount_classify_packed`` launch over rows of W
    >= 0 words and C >= 1 classes, any number of samples (a block a tile
    of 32; the layout depends on W and C alone).

    The tile kernel takes the launch where its block fits shared memory
    (W <= 1565 at C = 5) and C <= :data:`MAX_CLASSES`; the row's words
    are split over one warp per :data:`WARP_WORDS` words, at most
    :data:`MAX_TILE_WARPS`.  Every other shape runs the rows kernel (any
    W and C, as before).  Cached: a wrapper call looks its plan up, it
    does not plan again.
    """
    smem = _tiles_smem_bytes(W, C)
    if C > MAX_CLASSES or smem > MAX_SMEM_BYTES:
        return PopcountPlan("rows", 0, 0)
    return PopcountPlan("tiles", min(MAX_TILE_WARPS,
                                     max(1, -(-W // WARP_WORDS))), smem)


def _outputs(B: int, C: int, device: torch.device):
    return (torch.empty((B, C), dtype=torch.float32, device=device),
            torch.empty((B,), dtype=torch.int32, device=device))


def popcount_classify(bits: torch.Tensor, num_classes: int):
    """bits (B, m) float32 -> (counts (B, classes) float32, idx (B,)
    int32): class c sums the contiguous group ``[c*g, (c+1)*g)``, g = m /
    classes, then the first argmax (ties go to the lower class).  Raises
    ``ValueError`` unless ``num_classes`` divides m."""
    if device_type(bits, "popcount_classify") == "cpu":
        return popcount_classify_plain(bits, num_classes)
    dev = bits.device
    expect(bits, "bits", torch.float32, 2, dev)
    B, m = bits.shape
    class_group(m, num_classes)
    counts, idx = _outputs(B, num_classes, dev)
    if B == 0:
        return counts, idx
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "popcount_classify", dev,
           lambda stream: lib.popcount_classify_launch(
               bits.data_ptr(), B, m, num_classes, counts.data_ptr(),
               idx.data_ptr(), stream), _COUNTS)
    return counts, idx


def popcount_classify_packed(words: torch.Tensor,
                             class_masks: torch.Tensor):
    """words (B, W), class_masks (classes, W) -> (counts (B, classes)
    float32, idx (B,) int32): masked popcount per class and the first
    argmax (ties go to the lower class).  On CUDA both word tensors are
    int32 bit patterns; on the CPU the plain version takes either
    carrier."""
    if device_type(words, "popcount_classify_packed") == "cpu":
        return popcount_classify_packed_plain(words, class_masks)
    dev = words.device
    expect(words, "words", torch.int32, 2, dev)
    expect(class_masks, "class_masks", torch.int32, 2, dev)
    B, W = words.shape
    C = class_masks.shape[0]
    if class_masks.shape[1] != W or C < 1:
        raise ValueError(f"class_masks have shape "
                         f"{tuple(class_masks.shape)}; the words have {W} "
                         f"per row and there must be at least one class")
    counts, idx = _outputs(B, C, dev)
    if B == 0:
        return counts, idx
    plan = plan_popcount_classify_packed(W, C)
    lib = bind(LIBRARY, _SIGNATURES)
    _LAST[0] = None
    ptrs = (words.data_ptr(), B, W, class_masks.data_ptr(), C,
            counts.data_ptr(), idx.data_ptr())
    if plan.path == "rows":
        launch(lib, LIBRARY, "popcount_classify_packed", dev,
               lambda stream: lib.popcount_classify_packed_rows_launch(
                   *ptrs, stream), _COUNTS)
    else:
        launch(lib, LIBRARY, "popcount_classify_packed", dev,
               lambda stream: lib.popcount_classify_packed_launch(
                   *ptrs, plan.warps, plan.smem_bytes, stream), _COUNTS)
    _LAST[0] = plan
    return counts, idx


__all__ = ["PopcountPlan", "last_launch", "launch_counts",
           "plan_popcount_classify_packed", "popcount_classify",
           "popcount_classify_packed", "reset_launch_counts"]
