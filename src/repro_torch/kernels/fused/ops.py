"""Serving entry point of the fused DWN kernels: operand prep done once.

``make_forward_packed`` stages every batch-independent operand of the
selected kernel variant on the thresholds' device — wire indices, layers
padded to 32 LUTs with all-zero tables, truth tables packed one bit per
entry, class masks — and returns ``fn(x) -> (counts, idx)`` that only
launches.  The variant and the samples per CUDA block come from a
:class:`~repro_torch.kernels.autotune.FusedConfig`.
"""

from __future__ import annotations

import torch

from ...core.bitpack import group_masks, to_word_pattern
from ..autotune import DEFAULT_CONFIG
from .kernel import fused_dwn_batch_major, fused_dwn_packed
from .ref import LayerStack, first_layer_wires


def prepare_operands(thresholds: torch.Tensor, mappings, tables,
                     num_classes: int, variant: str = "packed") -> tuple:
    """The operands of one kernel variant after ``x``, staged on the
    thresholds' device: ``(thresholds, layers, class_masks)`` for
    ``kernel.fused_dwn_packed`` or ``(wire_f, wire_th, tab0, rest,
    class_masks)`` for ``kernel.fused_dwn_batch_major`` (the plain versions
    in ``ref.py`` take the same).

    Args:
      thresholds: (F, T) float32.
      mappings / tables: per layer (m, n) wire indices and (m, 2^n) {0,1}
        tables (single tensors accepted for one layer).
      num_classes: class groups of the last layer.
      variant: ``"packed"`` or ``"batch-major"``.

    Raises ``ValueError`` for operands the kernels cannot take (an
    out-of-range wire, a malformed table).
    """
    if not isinstance(mappings, (list, tuple)):
        mappings, tables = [mappings], [tables]
    thresholds = thresholds.to(torch.float32).contiguous()
    device = thresholds.device
    F, T = thresholds.shape
    masks = to_word_pattern(group_masks(mappings[-1].shape[0], num_classes,
                                        device)).contiguous()
    if variant == "batch-major":
        wire_f, wire_th, tab0 = first_layer_wires(thresholds, mappings[0],
                                                  tables[0])
        rest = LayerStack.build(mappings[1:], tables[1:],
                                mappings[0].shape[0], device)
        return wire_f, wire_th, tab0, rest, masks
    if variant != "packed":
        raise ValueError(f"unknown fused variant {variant!r}")
    return (thresholds, LayerStack.build(mappings, tables, F * T, device),
            masks)


def make_forward_packed(thresholds: torch.Tensor, mappings, tables,
                        num_classes: int, *, config=None):
    """Build ``fn(x) -> (counts (B, classes) float32, idx (B,) int32)``.

    Operands as :func:`prepare_operands`; ``config`` is a ``FusedConfig``
    (default :data:`DEFAULT_CONFIG`):

    * ``variant="packed"``: encode packs the full F*T bit tensor, then
      word-addressed LUT layers.  Any F*T: a ragged last word carries zero
      pad bits.
    * ``variant="batch-major"``: the first layer compares only its m0*n
      wired bits; later layers are word-addressed.

    Any batch size works.
    """
    config = DEFAULT_CONFIG if config is None else config
    operands = prepare_operands(thresholds, mappings, tables, num_classes,
                                config.variant)
    kernel = (fused_dwn_batch_major if config.variant == "batch-major"
              else fused_dwn_packed)

    def fn(x: torch.Tensor):
        return kernel(x, *operands, block_b=config.block_b)
    return fn


def forward_packed(x: torch.Tensor, thresholds: torch.Tensor, mappings,
                   tables, num_classes: int, *, config=None):
    """Whole-model packed inference in one launch: features -> (counts
    (B, classes) float32, idx (B,) int32).  One-shot wrapper over
    :func:`make_forward_packed` (operands staged on every call)."""
    return make_forward_packed(thresholds, mappings, tables, num_classes,
                               config=config)(x)


__all__ = ["forward_packed", "make_forward_packed", "prepare_operands"]
