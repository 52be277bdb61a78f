"""Launch wrappers of the fused DWN CUDA kernels (``csrc/fused_dwn.cu``).

``fused_dwn``
    the float datapath of one LUT layer with float32 tables: compares the
    m*n wired bits, reads each LUT's table entry, sums class counts, then
    the first argmax (counterpart of the reference's Pallas
    ``fused_dwn``).  Its LUTs are cut into slices that a block stages once
    and keeps (:func:`plan_fused_dwn`); a lane adds its sample's outputs of
    up to 32 LUTs of a class (a chunk) in LUT order, and a small second
    kernel, ``fused_dwn_combine``, adds each class's chunk sums in chunk
    order and takes the argmax, so the sums never depend on the layout.
``fused_dwn_packed``
    encodes all F*T thermometer bits into packed words, runs every LUT
    layer word-addressed, then a masked popcount and the first argmax
    (counterpart of the reference's Pallas ``fused_dwn_packed``).
``fused_dwn_batch_major``
    compares only the m0*n wired bits of the first layer (direct-wire),
    packs that layer's outputs and runs the rest word-addressed
    (counterpart of the reference's Pallas ``fused_dwn_batch_major``).

The two packed kernels stage the model once per CUDA block in shared
memory and let a warp's 32 lanes be 32 samples, so every read of the
model is one broadcast (``csrc/fused_dwn.cu`` says how).  A block takes
``block_b`` samples at a time (a tile, a multiple of 32); when a batch has
fewer tiles than the card has SMs, or the last layer does not fit a
block's shared memory whole, the last layer's LUTs are split over several
blocks per tile, which add their class counts into the output: a small
kernel, ``fused_dwn_zero``, zeroes it first on the launch's stream.  A
model that does not fit even so (a fan-in-16 table is 8 KB a LUT), or
deeper than :data:`INLINE_LAYERS` layers, is read from
global memory with the same broadcasts.  Where even the features and
activations of one tile of 32 samples do not fit a block, they lie in a
global scratch, a part for each block of the grid, which stays in L2
(:func:`check_activation_width` picks the path, :func:`scratch_blocks`
sizes the scratch).

All return ``(counts (B, classes) float32, idx (B,) int32)`` for any B.
For tensors on the CPU a wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`, and one
to ``fused_dwn_zero``'s when the zero kernel ran first (to
``fused_dwn_combine``'s for the float kernel's combine).
:func:`last_launch` says how the latest packed launch laid itself out,
:func:`last_float_launch` the latest ``fused_dwn``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .._launch import (I, LaunchCounts, P, bind, device_type, expect,
                       launch, sm_count)
from ..autotune import DEFAULT_CONFIG
from .ref import (MAX_FAN_IN, LayerStack, fused_dwn_batch_major_plain,
                  fused_dwn_combine_plain, fused_dwn_packed_plain,
                  fused_dwn_plain)

LIBRARY = "fused_dwn"
#: a tile of the packed kernels is a multiple of one warp's 32 lanes,
#: one sample each.
TILE_ROWS = 32
#: dynamic shared memory one block may use on an H100.
MAX_SMEM_BYTES = 232_448

#: layers whose descriptors a packed launch passes by value, K1's direct
#: first layer among them (== kMaxStack in the source); a deeper stack's
#: later layers are read from ``LayerStack.meta_dev`` in device memory,
#: unstaged (``last_launch()["device_layers"]`` counts them).
INLINE_LAYERS = 9
#: widest fan-in ``fused_dwn`` takes (the port's ``ref.MAX_FAN_IN``):
#: 2^16 table entries per LUT.
FUSED_DWN_MAX_FAN_IN = MAX_FAN_IN
#: widest fan-in of ``fused_dwn``'s tiles and rows kernels (2^8 entries a
#: LUT); wider LUTs take its global path (:func:`plan_fused_dwn`).
FUSED_DWN_TILE_FAN_IN = 8
#: ``fused_dwn``'s samples per tile when no ``FusedConfig`` is given (its
#: slices are then as wide as fit a block: :func:`plan_fused_dwn`; chosen
#: on the card: PERF.md).
FUSED_DWN_BLOCK_B = 32
#: LUTs of a chunk of ``fused_dwn``: the outputs one lane adds in order.
CHUNK_LUTS = 32
#: bytes of one LUT's staged wires in ``fused_dwn`` (8 uint16 feature
#: offsets, 8 float thresholds).
_WIRE_BYTES = 48

_COUNTS = LaunchCounts("fused_dwn", "fused_dwn_combine", "fused_dwn_packed",
                       "fused_dwn_batch_major", "fused_dwn_zero")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {
    "fused_dwn_launch": [P, P, I, I, I, P, P, I, I, I, P, P, P, I, I, I, I,
                         I, I, I, P, P],
    "fused_dwn_rows_launch": [P, P, I, I, I, P, P, I, I, I, P, P, I, I, P],
    "fused_dwn_global_launch": [P, P, I, I, I, P, P, I, I, I, P, P, P, I,
                                I, I, I, P, P],
    "fused_dwn_packed_launch": [P, P, I, I, I, P, P, I, P, P, P, I, I, P, P,
                                P, I, I, P, I, I, P, P],
    "fused_dwn_batch_major_launch": [P, I, I, P, P, P, I, I, I, P, P, I, P,
                                     P, P, I, I, P, P, P, I, I, P, I, I, P,
                                     P],
    "fused_dwn_combine_launch": [P, I, I, I, P, P, P],
    "fused_dwn_zero_launch": [P, I, P],
    "fused_tiles_scratch_blocks": [I, I],
}
#: how the latest packed launch laid itself out (see :func:`last_launch`)
_LAST: dict = {}
_LAUNCH_INFO = ("zeroed", "staged", "slices", "tile_rows", "smem_bytes",
                "scratch", "device_layers")
#: the latest ``fused_dwn`` (see :func:`last_float_launch`)
_LAST_FLOAT: dict = {}
_FLOAT_INFO = ("walkers", "blocks_per_sm")


def last_launch() -> dict:
    """The latest ``fused_dwn_packed`` / ``fused_dwn_batch_major`` launch
    of this process: ``zeroed`` (the zero kernel ran first), ``staged``
    (the model was staged in shared memory, else read from global
    memory), ``slices`` (blocks per tile that split the last layer),
    ``tile_rows`` (samples per tile), ``smem_bytes`` (dynamic shared
    memory of a block), ``scratch`` (features and activations in the
    global scratch: :func:`check_activation_width`) and
    ``device_layers`` (layers whose descriptors the blocks read from
    ``LayerStack.meta_dev``: those past :data:`INLINE_LAYERS`)."""
    return dict(_LAST)


def min_tile_smem(F: int, num_classes: int, act_words: int,
                  buffers: int) -> int:
    """Dynamic shared memory of the smallest block of the packed kernels,
    one tile of 32 samples with the model left in global memory: two
    feature buffers, ``buffers`` (0-2) activation buffers of ``act_words``
    words a sample, the class counts and a flag, as the launch lays them
    out."""
    return 4 * TILE_ROWS * (2 * F + buffers * act_words + num_classes) + 16


def _activations(variant: str, F: int, T: int, lut_counts):
    """(widest activations in words a sample, activation buffers) of a
    tile of the ``variant`` kernel: the packed encode's F*T bits and every
    layer's outputs but the last (batch-major compares its first layer's
    wires directly), in up to two alternating buffers."""
    widths = [(m + 31) // 32 for m in lut_counts[:-1]]
    if variant == "packed":
        widths.append((F * T + 31) // 32)
    return max(widths, default=0), min(len(widths), 2)


def check_activation_width(variant: str, F: int, T: int, lut_counts,
                           num_classes: int) -> str:
    """Where a tile of 32 samples of the ``variant`` kernel keeps its
    features and activations: ``"shared"`` where they fit a block's
    shared memory (:func:`min_tile_smem`), the path of every launch that
    fits, else ``"global"``: a global scratch of :func:`scratch_words`
    words for each of :func:`scratch_blocks` blocks, the model read from
    global memory.  ``lut_counts``: LUTs of every layer, first to last."""
    width, buffers = _activations(variant, F, T, lut_counts)
    if min_tile_smem(F, num_classes, width, buffers) <= MAX_SMEM_BYTES:
        return "shared"
    return "global"


def scratch_words(variant: str, F: int, T: int, lut_counts,
                  num_classes: int) -> int:
    """Words of one block's part of the global scratch: a tile's features
    ([f][lane]) and its activation buffers ([word][lane]), and its class
    counts where they do not fit a block's shared memory (more than 1,815
    classes)."""
    width, buffers = _activations(variant, F, T, lut_counts)
    counts = 4 * TILE_ROWS * num_classes + 16 > MAX_SMEM_BYTES
    return TILE_ROWS * (F + buffers * width + counts * num_classes)


def scratch_blocks(B: int, last_words: int) -> int:
    """Blocks of a K1 or K2 launch of ``B`` samples on the global path on
    the current CUDA device, each with its part of the scratch, whose
    last layer packs to ``last_words`` words: the source's own count
    (``fused_tiles_scratch_blocks``, from the tiles, slices and walkers
    the launch lays out)."""
    lib = bind(LIBRARY, _SIGNATURES)
    blocks = lib.fused_tiles_scratch_blocks(B, last_words)
    if blocks < 1:
        raise RuntimeError(f"fused_tiles_scratch_blocks({B}, {last_words}) "
                           f"returned {blocks}")
    return blocks


def _check_stack(layers: LayerStack, device: torch.device) -> None:
    """Any depth: past :data:`INLINE_LAYERS` a launch reads the layers'
    meta rows from ``meta_dev``."""
    for t, name in ((layers.wires, "wires"), (layers.tab, "tab")):
        expect(t, name, torch.int32, 1, device)
    expect(layers.meta_dev, "meta_dev", torch.int32, 2, device)


def _check_masks(class_masks: torch.Tensor, last_m: int,
                 device: torch.device) -> int:
    expect(class_masks, "class_masks", torch.int32, 2, device)
    if class_masks.shape[1] != last_m // 32:
        raise ValueError(f"class_masks have {class_masks.shape[1]} words; "
                         f"the last layer packs to {last_m // 32}")
    return class_masks.shape[0]


def fused_dwn_combine(part: torch.Tensor, num_classes: int):
    """``fused_dwn``'s second kernel on its own (``fused_dwn`` launches it
    itself): part (C * cpc, B) float32, each chunk's sum per sample, a
    class's chunks consecutive -> (counts (B, C) float32, idx (B,)
    int32), each class's chunks added in order, then the first argmax.
    On the CPU: ``ref.fused_dwn_combine_plain``."""
    if device_type(part, "fused_dwn_combine") == "cpu":
        return fused_dwn_combine_plain(part, num_classes)
    expect(part, "part", torch.float32, 2, part.device)
    if num_classes < 1 or part.shape[0] % num_classes:
        raise ValueError(f"part has {part.shape[0]} rows, not whole chunks "
                         f"of {num_classes} classes")
    B = part.shape[1]
    counts = torch.empty((B, num_classes), dtype=torch.float32,
                         device=part.device)
    idx = torch.empty((B,), dtype=torch.int32, device=part.device)
    if B:
        lib = bind(LIBRARY, _SIGNATURES)
        launch(lib, LIBRARY, "fused_dwn_combine", part.device,
               lambda stream: lib.fused_dwn_combine_launch(
                   part.data_ptr(), B, num_classes,
                   part.shape[0] // num_classes, counts.data_ptr(),
                   idx.data_ptr(), stream), _COUNTS)
    return counts, idx


def _launch_tiles(name: str, x: torch.Tensor, call, num_classes: int,
                  block_b: int, scratch=None):
    """Allocate outputs, run ``call(lib, counts, idx, arrive, scratch,
    info, stream)`` on the current stream and raise on any CUDA error it
    returns.  ``arrive`` holds a counter per tile (at most one per 32
    samples), right after ``counts`` in one buffer: when blocks split a
    tile's last layer the launch zeroes both first, and the blocks add
    into them.  ``scratch``: None, or (blocks, words a block) of the
    global path's scratch, allocated here.  ``info`` receives the
    launch's layout (:func:`last_launch`)."""
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    B = x.shape[0]
    buf = torch.empty((B * num_classes + (B + TILE_ROWS - 1) // TILE_ROWS,),
                      dtype=torch.int32, device=x.device)
    counts = buf[:B * num_classes].view(torch.float32).view(B, num_classes)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return counts, idx
    arrive = buf[B * num_classes:]
    scr = (None if scratch is None else
           torch.empty(scratch[0] * scratch[1], dtype=torch.int32,
                       device=x.device))
    info = (ctypes.c_int * len(_LAUNCH_INFO))()
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, name, x.device,
           lambda stream: call(lib, counts, idx, arrive, scr, info, stream),
           _COUNTS)
    _LAST.update(zip(_LAUNCH_INFO, info))
    if info[0]:
        _COUNTS.add("fused_dwn_zero")
    return counts, idx


def fused_dwn_zero(t: torch.Tensor) -> torch.Tensor:
    """Zero a contiguous 4-byte tensor in place with the kernel that
    zeroes a split launch's outputs (the packed kernels launch it
    themselves; this runs it on its own).  On the CPU: ``t.zero_()``."""
    if device_type(t, "fused_dwn_zero") == "cpu":
        return t.zero_()
    if t.element_size() != 4 or not t.is_contiguous():
        raise ValueError("fused_dwn_zero takes a contiguous tensor of "
                         "4-byte elements")
    if t.numel():
        lib = bind(LIBRARY, _SIGNATURES)
        launch(lib, LIBRARY, "fused_dwn_zero", t.device,
               lambda stream: lib.fused_dwn_zero_launch(
                   t.data_ptr(), t.numel(), stream), _COUNTS)
    return t


def last_float_launch() -> dict:
    """The latest ``fused_dwn`` launch of this process: its
    :class:`FloatPlan` fields and, on the ``"tiles"`` and ``"global"``
    paths, ``walkers`` (blocks that walk one slice's tiles) and
    ``blocks_per_sm`` as the launch found them."""
    return dict(_LAST_FLOAT)


@dataclasses.dataclass(frozen=True)
class FloatPlan:
    """How ``fused_dwn`` lays out one launch (:func:`plan_fused_dwn`).

    ``path`` is ``"tiles"`` (tiles of ``tile_rows`` samples, a multiple of
    32, and ``slices`` blocks per tile, each staging up to ``cs`` chunks),
    ``"rows"`` (the port's first float kernel, kept for features too
    wide for a tile of 32 samples: ``tile_rows`` rows and ``block_m`` LUTs
    a step per block) or ``"global"`` (fan-in above 8, or LUTs or rows
    that no block holds: tiles of 32 samples, ``slices`` slices of ``cs``
    chunks read from global memory, ``ucs == cs`` and ``ppc == 1``;
    ``smem_bytes`` the tile's features, or 0 where they are read from
    global memory too).  Slice s is piece ``s % ppc``, of ``cs`` chunks,
    of unit ``s // ppc``, which holds chunks ``[u * ucs, u * ucs + ucs)``:
    whole class groups when ``ppc == 1``, else one group cut into pieces.
    ``chunks``: the counted LUTs' chunks, C * ceil((m // C) / 32), the
    rows of the kernel's scratch.  ``block_m``: LUTs of a slice (tiles)
    or of a step (rows).
    """

    path: str
    tile_rows: int
    slices: int
    ucs: int
    ppc: int
    cs: int
    chunks: int
    block_m: int
    smem_bytes: int

    def slice_ranges(self) -> list[tuple[int, int]]:
        """Each slice's chunks ``[c0, c1)``, as the kernel computes them."""
        out = []
        for s in range(self.slices):
            u, piece = divmod(s, self.ppc)
            c0 = u * self.ucs + piece * self.cs
            c1 = min(self.chunks, (u + 1) * self.ucs, c0 + self.cs)
            out.append((c0, max(c0, c1)))
        return out


def _rows_smem_bytes(F: int, C: int, n: int, block_b: int,
                     block_m: int) -> int:
    """Shared memory one block of the rows kernel takes: one step's
    tables and wires, its rows' features and each lane's class sums."""
    return 4 * (block_m * (2 ** n + 2 * n) + block_b * (F + 32 * C))


def _tiles_smem_bytes(F: int, n: int, groups: int, cs: int) -> int:
    """Shared memory of a ``fused_dwn`` block (fused_dwn_tiles_smem in the
    source): ``cs`` chunks' tables and wires, two feature buffers of
    ``groups`` 32-sample groups."""
    return cs * 32 * (4 * 2 ** n + _WIRE_BYTES) + 2 * groups * F * 128


def _slices(cpc: int, chunks: int, k: int, ppc: int):
    """(ucs, ppc, cs, slices) for units of ``k`` class groups (``ppc`` 1)
    or one group cut into ``ppc`` pieces; ``cpc`` chunks a group."""
    if chunks == 0:
        return 1, 1, 1, 1
    if ppc == 1:
        ucs = cs = k * cpc
    else:
        ucs, cs = cpc, -(-cpc // ppc)
        ppc = -(-cpc // cs)
    return ucs, ppc, cs, -(-chunks // ucs) * ppc


def plan_fused_dwn(B: int, F: int, m: int, n: int, C: int, block_b: int,
                   block_m: int | None, sms: int) -> FloatPlan:
    """The layout of a ``fused_dwn`` launch of B >= 1 samples on a card of
    ``sms`` SMs, for every shape.

    * The path follows the shapes alone: a fan-in above
      :data:`FUSED_DWN_TILE_FAN_IN` (a LUT's table is 2 KB to 256 KB), or
      an explicit ``block_m`` whose LUTs' tables and wires alone exceed a
      block, takes the global path (:func:`_plan_global`).  Where two
      tiles of 32 samples' features take more than half a block's shared
      memory (F > 454: each slice would stage them again for a sliver of
      the model), the rows kernel takes the launch (:func:`_plan_rows`),
      or the global path where not even one row fits beside one LUT; else
      the tiles.
    * ``block_m`` is the most LUTs a slice holds (None: as many as fit a
      block): cut to whole chunks of 32 (at least one) and to what fits
      beside the features, then to whole class groups where one fits,
      else to equal pieces of one group.  A slice never holds parts of two
      groups.
    * ``block_b`` is the samples of a tile: rounded up to a multiple of 32,
      to no more than B fills, and down to what fits shared memory.
    * With fewer tiles than SMs the slices are cut narrower (fewer groups
      a slice, then more pieces a group) until tiles x slices fill the
      card, as K1 and K2 split their last layer.
    """
    lut = 4 * (2 ** n + 2 * n)    # rows kernel: one LUT's table and wires
    g = m // C
    cpc = -(-g // CHUNK_LUTS)
    chunks = C * cpc
    if n > FUSED_DWN_TILE_FAN_IN or (
            block_m is not None and min(block_m, m) * lut > MAX_SMEM_BYTES):
        return _plan_global(B, F, chunks, block_m, sms)
    if _tiles_smem_bytes(F, n, 1, 0) > MAX_SMEM_BYTES // 2:
        return (_plan_rows(B, F, m, n, C, block_b, block_m, chunks)
                or _plan_global(B, F, chunks, block_m, sms))
    fit = (MAX_SMEM_BYTES - _tiles_smem_bytes(F, n, 1, 0)) // \
        _tiles_smem_bytes(0, n, 0, 1)         # chunks beside the features
    cap = fit if block_m is None else min(fit, block_m // CHUNK_LUTS)
    cap = max(1, min(cap, chunks))
    k, ppc = (cap // cpc, 1) if 0 < cpc <= cap else (1, -(-cpc // cap))
    ucs, _, cs, _ = _slices(cpc, chunks, k, ppc)
    groups = min(-(-block_b // TILE_ROWS), -(-B // TILE_ROWS))
    while groups > 1 and _tiles_smem_bytes(F, n, groups, cs) > \
            MAX_SMEM_BYTES:
        groups -= 1
    tiles = -(-B // (TILE_ROWS * groups))
    want = max(1, (sms + tiles // 2) // tiles)
    shape = _slices(cpc, chunks, k, ppc)
    while shape[3] < want and shape[2] > 1:
        if k > 1:
            k -= 1
        else:
            ppc += 1
        shape = _slices(cpc, chunks, k, ppc)
    ucs, ppc, cs, slices = shape
    return FloatPlan("tiles", TILE_ROWS * groups, slices, ucs, ppc, cs,
                     chunks, cs * CHUNK_LUTS,
                     _tiles_smem_bytes(F, n, groups, cs))


def _plan_rows(B, F, m, n, C, block_b, block_m, chunks):
    """The rows kernel for features too wide for a tile: ``block_m`` LUTs
    a step (None: as many as fit beside one row; an explicit one cut to
    that), then ``block_b`` rows cut to what fits beside them; None where
    not even one row fits beside one LUT."""
    lut = 2 ** n + 2 * n          # floats of one LUT's table and wires
    row = F + 32 * C              # floats of one row's features and sums
    fit = min(m, (MAX_SMEM_BYTES // 4 - row) // lut)
    if fit < 1:
        return None
    bm = fit if block_m is None else min(block_m, fit)
    bb = max(1, min(block_b, B, (MAX_SMEM_BYTES // 4 - bm * lut) // row))
    return FloatPlan("rows", bb, 1, 0, 0, 0, chunks, bm,
                     _rows_smem_bytes(F, C, n, bb, bm))


def _plan_global(B, F, chunks, block_m, sms) -> FloatPlan:
    """The global path: tiles of 32 samples, the chunks cut into slices
    (blocks per tile) until tiles x slices fill the card, at most
    ``block_m`` LUTs a slice; the tile's features staged where 32 samples'
    fit a block."""
    tiles = -(-B // TILE_ROWS)
    S = max(1, min(chunks, (sms + tiles // 2) // tiles))
    cs = max(1, -(-chunks // S))
    if block_m is not None:
        cs = min(cs, max(1, block_m // CHUNK_LUTS))
    cs = max(cs, -(-chunks // 65535))         # grid.y
    smem = 4 * TILE_ROWS * F
    return FloatPlan("global", TILE_ROWS, max(1, -(-chunks // cs)), cs, 1,
                     cs, chunks, cs * CHUNK_LUTS,
                     smem if smem <= MAX_SMEM_BYTES else 0)


def fused_dwn(x: torch.Tensor, thresholds: torch.Tensor,
              mapping: torch.Tensor, tables: torch.Tensor, num_classes: int,
              *, block_b: int = FUSED_DWN_BLOCK_B,
              block_m: int | None = None):
    """One float LUT layer, fused: features -> (counts, idx).

    x (B, F) float32; thresholds (F, T) float32; mapping (m, n) int32 wire
    indices in [0, F*T) (the op checks them; the kernel does not); tables
    (m, 2^n) float32 with finite entries (the kernel reads the addressed
    entry, which equals the reference's corner product only for finite
    tables); 1 <= n <= :data:`FUSED_DWN_MAX_FAN_IN`.  LUT l counts for class
    ``l // (m // num_classes)``; LUTs past the last whole group count for
    no class.  ``block_b`` (samples of a tile) and ``block_m`` (most LUTs
    of a slice; None: as many as fit) as :func:`plan_fused_dwn` rounds
    them; on the tiles and global paths the results do not depend on
    them, nor on B: each class sums its chunks of 32 LUTs in order, each
    chunk in LUT order.
    Returns (counts (B, classes) float32, idx (B,) int32).
    """
    if device_type(x, "fused_dwn") == "cpu":
        return fused_dwn_plain(x, thresholds, mapping, tables, num_classes)
    dev = x.device
    expect(x, "x", torch.float32, 2, dev)
    expect(thresholds, "thresholds", torch.float32, 2, dev)
    expect(mapping, "mapping", torch.int32, 2, dev)
    expect(tables, "tables", torch.float32, 2, dev)
    B, F = x.shape
    F_th, T = thresholds.shape
    m, n = mapping.shape
    if F_th != F:
        raise ValueError(f"x has {F} features, thresholds {F_th}")
    if not 1 <= n <= FUSED_DWN_MAX_FAN_IN:
        raise ValueError(f"fused_dwn takes a fan-in of 1 to "
                         f"{FUSED_DWN_MAX_FAN_IN}, got {n}")
    if tuple(tables.shape) != (m, 2 ** n) or m < 1:
        raise ValueError(f"tables have shape {tuple(tables.shape)}; "
                         f"expected {(m, 2 ** n)} with m >= 1")
    if num_classes < 1:
        raise ValueError(f"num_classes must be at least 1, got "
                         f"{num_classes}")
    if block_b < 1 or (block_m is not None and block_m < 1):
        raise ValueError(f"block_b and block_m must be >= 1, got "
                         f"{block_b} and {block_m}")
    sms = sm_count(dev)
    plan = plan_fused_dwn(max(B, 1), F, m, n, num_classes, block_b, block_m,
                          sms)
    counts = torch.empty((B, num_classes), dtype=torch.float32, device=dev)
    idx = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return counts, idx
    lib = bind(LIBRARY, _SIGNATURES)
    _LAST_FLOAT.clear()
    _LAST_FLOAT.update(dataclasses.asdict(plan))
    if plan.path == "rows":
        launch(lib, LIBRARY, "fused_dwn", dev,
               lambda stream: lib.fused_dwn_rows_launch(
                   x.data_ptr(), thresholds.data_ptr(), B, F, T,
                   mapping.data_ptr(), tables.data_ptr(), m, n, num_classes,
                   counts.data_ptr(), idx.data_ptr(), plan.tile_rows,
                   plan.block_m, stream), _COUNTS)
        return counts, idx
    part = torch.empty((plan.chunks, B), dtype=torch.float32, device=dev)
    info = (ctypes.c_int * len(_FLOAT_INFO))()
    ops = (x.data_ptr(), thresholds.data_ptr(), B, F, T, mapping.data_ptr(),
           tables.data_ptr(), m, n, num_classes, part.data_ptr(),
           counts.data_ptr(), idx.data_ptr())
    if plan.path == "global":
        launch(lib, LIBRARY, "fused_dwn", dev,
               lambda stream: lib.fused_dwn_global_launch(
                   *ops, plan.cs, plan.slices, sms, plan.smem_bytes, info,
                   stream), _COUNTS)
    else:
        launch(lib, LIBRARY, "fused_dwn", dev,
               lambda stream: lib.fused_dwn_launch(
                   *ops, plan.tile_rows // TILE_ROWS, plan.ucs, plan.ppc,
                   plan.cs, plan.slices, sms, plan.smem_bytes, info,
                   stream), _COUNTS)
    _COUNTS.add("fused_dwn_combine")
    _LAST_FLOAT.update(zip(_FLOAT_INFO, info))
    return counts, idx


def _scratch(variant: str, B: int, F: int, T: int, luts, C: int,
             device: torch.device):
    """None on the shared path, else (blocks, words a block) of the
    global path's scratch (:func:`check_activation_width`)."""
    if B == 0 or check_activation_width(variant, F, T, luts, C) == "shared":
        return None
    with torch.cuda.device(device):
        blocks = scratch_blocks(B, -(-luts[-1] // 32))
    return blocks, scratch_words(variant, F, T, luts, C)


def _scratch_args(scr, scratch) -> tuple:
    """The C entry's (global, scratch, blocks, words a block)."""
    if scratch is None:
        return 0, None, 0, 0
    return 1, scr.data_ptr(), scratch[0], scratch[1]


def fused_dwn_packed(x: torch.Tensor, thresholds: torch.Tensor,
                     layers: LayerStack, class_masks: torch.Tensor, *,
                     block_b: int = DEFAULT_CONFIG.block_b):
    """Whole-model packed inference in one launch.

    x (B, F) float32; thresholds (F, T) float32; ``layers`` the whole LUT
    stack (``ref.LayerStack``); class_masks (classes, m_last/32) int32
    words.  ``block_b`` (>= 1): the samples a CUDA block takes at a time
    (a tile), rounded up to a multiple of 32 (one sample per lane), to no
    more than B fills, and down to the most that fit a block's shared
    memory beside the model (:func:`last_launch` reports it; a launch on
    the global path of :func:`check_activation_width` takes tiles of 32);
    results do not depend on it.  Any depth, any width.
    Returns (counts (B, classes) float32, idx (B,) int32).
    """
    if device_type(x, "fused_dwn_packed") == "cpu":
        return fused_dwn_packed_plain(x, thresholds, layers, class_masks)
    dev = x.device
    expect(x, "x", torch.float32, 2, dev)
    expect(thresholds, "thresholds", torch.float32, 2, dev)
    if layers.num_layers < 1:
        raise ValueError("fused_dwn_packed needs at least one LUT layer")
    _check_stack(layers, dev)
    B, F = x.shape
    F_th, T = thresholds.shape
    if F_th != F:
        raise ValueError(f"x has {F} features, thresholds {F_th}")
    C = _check_masks(class_masks, layers.shapes[-1][0], dev)
    luts = [m for m, _ in layers.shapes]
    scratch = _scratch("packed", B, F, T, luts, C, dev)
    meta = layers.meta

    def call(lib, counts, idx, arrive, scr, info, stream):
        return lib.fused_dwn_packed_launch(
            x.data_ptr(), thresholds.data_ptr(), B, F, T,
            meta.ctypes.data, layers.meta_dev.data_ptr(), layers.num_layers,
            layers.wires.data_ptr(), layers.tab.data_ptr(),
            class_masks.data_ptr(), C, class_masks.shape[1],
            counts.data_ptr(), idx.data_ptr(), arrive.data_ptr(), block_b,
            *_scratch_args(scr, scratch), info, stream)
    return _launch_tiles("fused_dwn_packed", x, call, C, block_b, scratch)


def fused_dwn_batch_major(x: torch.Tensor, wire_f: torch.Tensor,
                          wire_th: torch.Tensor, tab0: torch.Tensor,
                          rest: LayerStack, class_masks: torch.Tensor, *,
                          block_b: int = DEFAULT_CONFIG.block_b):
    """Batch-major direct-wire inference in one launch.

    x (B, F) float32; wire_f (m0, n) int16 feature index and wire_th
    (m0, n) float32 threshold of every first-layer wire, tab0 (m0, tw)
    int32 table words (m0 a multiple of 32; ``ref.first_layer_wires``);
    ``rest`` the layers after the first (possibly none); class_masks
    (classes, m_last/32) int32 words.  ``block_b`` as in
    :func:`fused_dwn_packed`.  Returns (counts, idx) as
    :func:`fused_dwn_packed`.
    """
    if device_type(x, "fused_dwn_batch_major") == "cpu":
        return fused_dwn_batch_major_plain(x, wire_f, wire_th, tab0, rest,
                                           class_masks)
    dev = x.device
    expect(x, "x", torch.float32, 2, dev)
    expect(wire_f, "wire_f", torch.int16, 2, dev)
    expect(wire_th, "wire_th", torch.float32, 2, dev)
    expect(tab0, "tab0", torch.int32, 2, dev)
    _check_stack(rest, dev)
    B, F = x.shape
    m0, n0 = wire_f.shape
    if m0 % 32 != 0 or wire_th.shape != wire_f.shape or \
            tab0.shape[0] != m0:
        raise ValueError(f"first-layer operands disagree: wire_f "
                         f"{tuple(wire_f.shape)}, wire_th "
                         f"{tuple(wire_th.shape)}, tab0 {tuple(tab0.shape)} "
                         f"(m0 must be a multiple of 32)")
    if tab0.shape[1] != (2 ** n0 + 31) // 32:
        raise ValueError(f"tab0 has {tab0.shape[1]} words per LUT; fan-in "
                         f"{n0} needs {(2 ** n0 + 31) // 32}")
    last_m = rest.shapes[-1][0] if rest.num_layers else m0
    C = _check_masks(class_masks, last_m, dev)
    luts = [m0, *(m for m, _ in rest.shapes)]
    scratch = _scratch("batch-major", B, F, 0, luts, C, dev)
    meta = rest.meta

    def call(lib, counts, idx, arrive, scr, info, stream):
        return lib.fused_dwn_batch_major_launch(
            x.data_ptr(), B, F, wire_f.data_ptr(), wire_th.data_ptr(),
            tab0.data_ptr(), m0, n0, tab0.shape[1],
            meta.ctypes.data if rest.num_layers else None,
            rest.meta_dev.data_ptr() if rest.num_layers else None,
            rest.num_layers, rest.wires.data_ptr(), rest.tab.data_ptr(),
            class_masks.data_ptr(), C, class_masks.shape[1],
            counts.data_ptr(), idx.data_ptr(), arrive.data_ptr(), block_b,
            *_scratch_args(scr, scratch), info, stream)
    return _launch_tiles("fused_dwn_batch_major", x, call, C, block_b,
                         scratch)


__all__ = ["CHUNK_LUTS", "FUSED_DWN_BLOCK_B", "FUSED_DWN_MAX_FAN_IN",
           "FUSED_DWN_TILE_FAN_IN", "FloatPlan", "INLINE_LAYERS",
           "check_activation_width", "fused_dwn", "fused_dwn_batch_major",
           "fused_dwn_combine", "fused_dwn_packed", "fused_dwn_zero",
           "last_float_launch", "last_launch", "launch_counts",
           "min_tile_smem", "plan_fused_dwn", "reset_launch_counts",
           "scratch_blocks", "scratch_words"]
