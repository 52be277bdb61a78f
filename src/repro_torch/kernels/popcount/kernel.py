"""Launch wrappers of the two popcount and classify CUDA kernels
(``csrc/popcount.cu``): ``popcount_classify`` (group sums of float32 bits)
and ``popcount_classify_packed`` (masked popcounts of packed words), the
counterparts of the reference's Pallas kernels of the same names.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import torch

from .._launch import I, LaunchCounts, P, bind, device_type, expect, launch
from .ref import (class_group, popcount_classify_packed_plain,
                  popcount_classify_plain)

LIBRARY = "popcount"
_COUNTS = LaunchCounts("popcount_classify", "popcount_classify_packed")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"popcount_classify_launch": [P, I, I, I, P, P, P],
               "popcount_classify_packed_launch": [P, I, I, P, I, P, P, P]}


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
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "popcount_classify_packed", dev,
           lambda stream: lib.popcount_classify_packed_launch(
               words.data_ptr(), B, W, class_masks.data_ptr(), C,
               counts.data_ptr(), idx.data_ptr(), stream), _COUNTS)
    return counts, idx


__all__ = ["launch_counts", "popcount_classify", "popcount_classify_packed",
           "reset_launch_counts"]
