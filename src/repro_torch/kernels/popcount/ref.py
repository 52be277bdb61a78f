"""Plain PyTorch versions of the two popcount and classify kernels (group
sums of float bits, masked popcounts of packed words)."""

from __future__ import annotations

import torch

from ...core.bitpack import from_word_pattern, masked_group_counts
from ...core.lut_layer import first_max_index


def class_group(m: int, num_classes: int) -> int:
    """LUTs per class, ``m / num_classes``; raises ``ValueError`` unless
    the m outputs split into ``num_classes`` equal groups."""
    if num_classes < 1 or m % num_classes != 0:
        raise ValueError(f"{m} outputs do not split into {num_classes} "
                         f"equal class groups")
    return m // num_classes


def popcount_classify_plain(bits: torch.Tensor, num_classes: int):
    """bits (B, m) float32 -> (counts (B, classes) float32, idx (B,)
    int32): class c sums bits ``[c*g, (c+1)*g)`` with ``g = m / classes``,
    then the first argmax (ties go to the lower class).  Raises
    ``ValueError`` unless ``num_classes`` divides m."""
    B, m = bits.shape
    g = class_group(m, num_classes)
    counts = bits.to(torch.float32).reshape(B, num_classes, g).sum(-1)
    return counts, first_max_index(counts)


def popcount_classify_packed_plain(words: torch.Tensor,
                                   class_masks: torch.Tensor):
    """words (B, W) and class_masks (classes, W), either carrier ->
    (counts (B, classes) float32, idx (B,) int32): the set bits of each
    word under each class mask, summed over words, then the first argmax
    (ties go to the lower class)."""
    counts = masked_group_counts(from_word_pattern(words),
                                 from_word_pattern(class_masks))
    return counts, first_max_index(counts)


__all__ = ["class_group", "popcount_classify_packed_plain",
           "popcount_classify_plain"]
