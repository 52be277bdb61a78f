"""Public ops of the classify stage (the reference's ``popcount/ops.py``:
``classify`` and ``classify_packed``)."""

from __future__ import annotations

import torch

from ...core.bitpack import (PackedBits, device_words, group_masks,
                             to_word_pattern)
from ...device import resolve_device
from .kernel import popcount_classify, popcount_classify_packed


def classify(bits, num_classes: int):
    """(B, m) layer-output bits (converted to float32; a non-tensor goes
    to the CUDA card, which must be present) -> (counts (B, classes)
    float32, idx (B,) int32).

    Class c sums the contiguous group ``[c*m/classes, (c+1)*m/classes)``;
    ``idx`` is the first argmax (ties go to the lower class).  Raises
    ``ValueError`` unless m splits into ``num_classes`` equal groups.  One
    kernel launch on CUDA.
    """
    if not isinstance(bits, torch.Tensor):
        bits = torch.as_tensor(bits, device=resolve_device())
    return popcount_classify(bits.to(torch.float32).contiguous(),
                             num_classes)


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


__all__ = ["classify", "classify_packed"]
