"""Launch wrappers of the fused DWN CUDA kernels (``csrc/fused_dwn.cu``).

``fused_dwn``
    the float datapath of one LUT layer with float32 tables: compares the
    m*n wired bits, reads each LUT's table entry, sums class counts tile by
    tile of ``block_m`` LUTs, then the first argmax (counterpart of the
    reference's Pallas ``fused_dwn``).
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
model that does not fit even so (a fan-in-16 table is 8 KB a LUT) is read
from global memory with the same broadcasts.  The activations of one tile
of 32 samples must fit a block's shared memory: the wrappers refuse wider
layers (:func:`check_activation_width`).

All return ``(counts (B, classes) float32, idx (B,) int32)`` for any B.
For tensors on the CPU a wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`, and one
to ``fused_dwn_zero``'s when the zero kernel ran first.
:func:`last_launch` says how the latest packed launch laid itself out.
"""

from __future__ import annotations

import ctypes

import torch

from .._launch import (I, LaunchCounts, P, bind, device_type, expect,
                       launch)
from ..autotune import DEFAULT_CONFIG
from .ref import (MAX_LAYERS, LayerStack, fused_dwn_batch_major_plain,
                  fused_dwn_packed_plain, fused_dwn_plain)

LIBRARY = "fused_dwn"
#: a tile of the packed kernels is a multiple of one warp's 32 lanes,
#: one sample each.
TILE_ROWS = 32
#: dynamic shared memory one block may use on an H100.
MAX_SMEM_BYTES = 232_448

#: widest fan-in ``fused_dwn`` takes: 2^8 table entries per LUT.
FUSED_DWN_MAX_FAN_IN = 8
#: ``fused_dwn``'s samples per block and LUTs per tile when no
#: ``FusedConfig`` is given (chosen on the card: PERF.md).
FUSED_DWN_BLOCK_B = 16
FUSED_DWN_BLOCK_M = 256

_COUNTS = LaunchCounts("fused_dwn", "fused_dwn_packed",
                       "fused_dwn_batch_major", "fused_dwn_zero")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {
    "fused_dwn_launch": [P, P, I, I, I, P, P, I, I, I, P, P, I, I, P],
    "fused_dwn_packed_launch": [P, P, I, I, I, P, I, P, P, P, I, I, P, P,
                                P, I, P, P],
    "fused_dwn_batch_major_launch": [P, I, I, P, P, P, I, I, I, P, I, P, P,
                                     P, I, I, P, P, P, I, P, P],
    "fused_dwn_zero_launch": [P, I, P],
}
#: how the latest packed launch laid itself out (see :func:`last_launch`)
_LAST: dict = {}
_LAUNCH_INFO = ("zeroed", "staged", "slices", "tile_rows", "smem_bytes")


def last_launch() -> dict:
    """The latest ``fused_dwn_packed`` / ``fused_dwn_batch_major`` launch
    of this process: ``zeroed`` (the zero kernel ran first), ``staged``
    (the model was staged in shared memory, else read from global
    memory), ``slices`` (blocks per tile that split the last layer),
    ``tile_rows`` (samples per tile) and ``smem_bytes`` (dynamic shared
    memory of a block)."""
    return dict(_LAST)


def min_tile_smem(F: int, num_classes: int, act_words: int,
                  buffers: int) -> int:
    """Dynamic shared memory of the smallest block of the packed kernels,
    one tile of 32 samples with the model left in global memory: two
    feature buffers, ``buffers`` (0-2) activation buffers of ``act_words``
    words a sample, the class counts and a flag, as the launch lays them
    out."""
    return 4 * TILE_ROWS * (2 * F + buffers * act_words + num_classes) + 16


def check_activation_width(variant: str, F: int, T: int, lut_counts,
                           num_classes: int) -> None:
    """Raise ``ValueError`` unless a tile of 32 samples of the ``variant``
    kernel fits a block's shared memory: its features and its widest
    activations (the packed encode's F*T bits and every layer's outputs
    but the last; batch-major compares its first layer's wires directly).
    ``lut_counts``: LUTs of every layer, first to last."""
    widths = [(m + 31) // 32 for m in lut_counts[:-1]]
    if variant == "packed":
        widths.append((F * T + 31) // 32)
    buffers = min(len(widths), 2)
    need = min_tile_smem(F, num_classes, max(widths, default=0), buffers)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_dwn_{variant.replace('-', '_')}: features ({F}) and "
            f"activations ({max(widths, default=0)} words a sample) of 32 "
            f"samples need {need} bytes of shared memory, over a block's "
            f"{MAX_SMEM_BYTES}")


def _check_stack(layers: LayerStack, device: torch.device) -> None:
    if layers.num_layers > MAX_LAYERS:
        raise ValueError(f"the CUDA kernels take at most {MAX_LAYERS} "
                         f"word-addressed layers, got {layers.num_layers}")
    for t, name in ((layers.wires, "wires"), (layers.tab, "tab")):
        expect(t, name, torch.int32, 1, device)


def _check_masks(class_masks: torch.Tensor, last_m: int,
                 device: torch.device) -> int:
    expect(class_masks, "class_masks", torch.int32, 2, device)
    if class_masks.shape[1] != last_m // 32:
        raise ValueError(f"class_masks have {class_masks.shape[1]} words; "
                         f"the last layer packs to {last_m // 32}")
    return class_masks.shape[0]


def _launch_tiles(name: str, x: torch.Tensor, call, num_classes: int,
                  block_b: int):
    """Allocate outputs, run ``call(lib, counts, idx, arrive, info,
    stream)`` on the current stream and raise on any CUDA error it
    returns.  ``arrive`` holds a counter per tile (at most one per 32
    samples), right after ``counts`` in one buffer: when blocks split a
    tile's last layer the launch zeroes both first, and the blocks add
    into them.  ``info`` receives the launch's layout
    (:func:`last_launch`)."""
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
    info = (ctypes.c_int * len(_LAUNCH_INFO))()
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, name, x.device,
           lambda stream: call(lib, counts, idx, arrive, info, stream),
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


def _fused_dwn_smem_bytes(F: int, C: int, n: int, block_b: int,
                         block_m: int) -> int:
    """Shared memory one block of ``fused_dwn`` takes: one tile's tables
    and wires, its rows' features and each lane's class sums."""
    return 4 * (block_m * (2 ** n + 2 * n) + block_b * (F + 32 * C))


def fused_dwn(x: torch.Tensor, thresholds: torch.Tensor,
              mapping: torch.Tensor, tables: torch.Tensor, num_classes: int,
              *, block_b: int = FUSED_DWN_BLOCK_B,
              block_m: int = FUSED_DWN_BLOCK_M):
    """One float LUT layer, fused: features -> (counts, idx).

    x (B, F) float32; thresholds (F, T) float32; mapping (m, n) int32 wire
    indices in [0, F*T) (the op checks them; the kernel does not); tables
    (m, 2^n) float32 with finite entries (the kernel reads the addressed
    entry, which equals the reference's corner product only for finite
    tables); 1 <= n <= :data:`FUSED_DWN_MAX_FAN_IN`.  LUT l counts for class
    ``l // (m // num_classes)``; LUTs past the last whole group count for
    no class.  ``block_b`` samples per CUDA block, ``block_m`` LUTs per
    tile; results do not depend on either beyond the order of float sums.
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
    if block_b < 1 or block_m < 1:
        raise ValueError(f"block_b and block_m must be >= 1, got "
                         f"{block_b} and {block_m}")
    block_b, block_m = min(block_b, max(B, 1)), min(block_m, m)
    smem = _fused_dwn_smem_bytes(F, num_classes, n, block_b, block_m)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_dwn: {smem} bytes of shared memory per "
                         f"block exceed the card's {MAX_SMEM_BYTES}; lower "
                         f"block_b or block_m")
    counts = torch.empty((B, num_classes), dtype=torch.float32, device=dev)
    idx = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return counts, idx
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "fused_dwn", dev,
           lambda stream: lib.fused_dwn_launch(
               x.data_ptr(), thresholds.data_ptr(), B, F, T,
               mapping.data_ptr(), tables.data_ptr(), m, n, num_classes,
               counts.data_ptr(), idx.data_ptr(), block_b, block_m, stream),
           _COUNTS)
    return counts, idx


def fused_dwn_packed(x: torch.Tensor, thresholds: torch.Tensor,
                     layers: LayerStack, class_masks: torch.Tensor, *,
                     block_b: int = DEFAULT_CONFIG.block_b):
    """Whole-model packed inference in one launch.

    x (B, F) float32; thresholds (F, T) float32; ``layers`` the whole LUT
    stack (``ref.LayerStack``); class_masks (classes, m_last/32) int32
    words.  ``block_b`` (>= 1): the samples a CUDA block takes at a time
    (a tile), rounded up to a multiple of 32 (one sample per lane), to no
    more than B fills, and down to the most that fit a block's shared
    memory beside the model (:func:`last_launch` reports it); results do
    not depend on it.  Raises ``ValueError`` if the activations of 32
    samples do not fit a block (:func:`check_activation_width`).
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
    check_activation_width("packed", F, T,
                           [m for m, _ in layers.shapes], C)
    meta = layers.meta

    def call(lib, counts, idx, arrive, info, stream):
        return lib.fused_dwn_packed_launch(
            x.data_ptr(), thresholds.data_ptr(), B, F, T,
            meta.ctypes.data, layers.num_layers, layers.wires.data_ptr(),
            layers.tab.data_ptr(), class_masks.data_ptr(), C,
            class_masks.shape[1], counts.data_ptr(), idx.data_ptr(),
            arrive.data_ptr(), block_b, info, stream)
    return _launch_tiles("fused_dwn_packed", x, call, C, block_b)


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
    check_activation_width("batch-major", F, 0,
                           [m0, *(m for m, _ in rest.shapes)], C)
    meta = rest.meta

    def call(lib, counts, idx, arrive, info, stream):
        return lib.fused_dwn_batch_major_launch(
            x.data_ptr(), B, F, wire_f.data_ptr(), wire_th.data_ptr(),
            tab0.data_ptr(), m0, n0, tab0.shape[1],
            meta.ctypes.data if rest.num_layers else None, rest.num_layers,
            rest.wires.data_ptr(), rest.tab.data_ptr(),
            class_masks.data_ptr(), C, class_masks.shape[1],
            counts.data_ptr(), idx.data_ptr(), arrive.data_ptr(), block_b,
            info, stream)
    return _launch_tiles("fused_dwn_batch_major", x, call, C, block_b)


__all__ = ["FUSED_DWN_BLOCK_B", "FUSED_DWN_BLOCK_M", "FUSED_DWN_MAX_FAN_IN",
           "check_activation_width", "fused_dwn", "fused_dwn_batch_major",
           "fused_dwn_packed", "fused_dwn_zero", "last_launch",
           "launch_counts", "min_tile_smem", "reset_launch_counts"]
