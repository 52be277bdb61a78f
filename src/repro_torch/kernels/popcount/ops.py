"""Public op of the packed classify (the reference's
``popcount/ops.py:classify_packed``)."""

from __future__ import annotations

from ...core.bitpack import (PackedBits, device_words, group_masks,
                             to_word_pattern)
from .kernel import popcount_classify_packed


def classify_packed(packed: PackedBits, num_classes: int):
    """``PackedBits`` of m layer-output bits (either word carrier) ->
    (counts (B, classes) float32, idx (B,) int32).

    Class c owns bits ``[c*m/classes, (c+1)*m/classes)``; the class masks
    absorb any misalignment of groups and words, and zero pad bits count
    nothing.  ``idx`` is the first argmax (ties go to the lower class).
    Raises ``ValueError`` unless m splits into ``num_classes`` equal
    groups.  One kernel launch on CUDA.
    """
    if num_classes < 1:
        raise ValueError(f"num_classes must be at least 1, got "
                         f"{num_classes}")
    words = device_words(packed.words).contiguous()
    masks = to_word_pattern(group_masks(packed.num_bits, num_classes,
                                        words.device))
    return popcount_classify_packed(words, masks.contiguous())


__all__ = ["classify_packed"]
