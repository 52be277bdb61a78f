"""Public ops of the classify stage (the reference's ``popcount/ops.py``:
``classify`` and ``classify_packed``)."""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=64)
def class_masks(num_bits: int, num_classes: int,
                device: torch.device) -> torch.Tensor:
    """The class-group masks of m = ``num_bits`` layer outputs as int32
    bit patterns on ``device``, made once per (num_bits, num_classes,
    device), as the reference stages its masks once per model: a call
    that finds them copies nothing to the device (a CUDA graph capture
    would refuse the copy).  Shared by every caller: read, never write."""
    return to_word_pattern(group_masks(num_bits, num_classes,
                                       device)).contiguous()


def classify_packed(packed: PackedBits, num_classes: int):
    """``PackedBits`` of m layer-output bits (either word carrier) ->
    (counts (B, classes) float32, idx (B,) int32).

    Class c owns bits ``[c*m/classes, (c+1)*m/classes)``; the class masks
    absorb any misalignment of groups and words, and zero pad bits count
    nothing.  ``idx`` is the first argmax (ties go to the lower class).
    Raises ``ValueError`` unless m splits into ``num_classes`` equal
    groups.  One kernel launch on CUDA; the masks are made on the first
    call for a (num_bits, num_classes, device) (:func:`class_masks`).
    """
    if num_classes < 1:
        raise ValueError(f"num_classes must be at least 1, got "
                         f"{num_classes}")
    words = device_words(packed.words).contiguous()
    return popcount_classify_packed(
        words, class_masks(packed.num_bits, num_classes, words.device))


__all__ = ["class_masks", "classify", "classify_packed"]
