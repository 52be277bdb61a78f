"""Plain PyTorch version of the masked popcount and classify kernel."""

from __future__ import annotations

import torch

from ...core.bitpack import from_word_pattern, masked_group_counts
from ...core.lut_layer import first_max_index


def popcount_classify_packed_plain(words: torch.Tensor,
                                   class_masks: torch.Tensor):
    """words (B, W) and class_masks (classes, W), either carrier ->
    (counts (B, classes) float32, idx (B,) int32): the set bits of each
    word under each class mask, summed over words, then the first argmax
    (ties go to the lower class)."""
    counts = masked_group_counts(from_word_pattern(words),
                                 from_word_pattern(class_masks))
    return counts, first_max_index(counts)


__all__ = ["popcount_classify_packed_plain"]
