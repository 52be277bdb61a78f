"""Entry points of the fused DWN kernels: the float ``forward`` and the
packed serving path, whose operand prep is done once.

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
from ...device import resolve_device
from ..autotune import DEFAULT_CONFIG
from ..lut_eval.ref import check_wires
from .kernel import (FUSED_DWN_BLOCK_B, FUSED_DWN_BLOCK_M,
                     check_activation_width, fused_dwn,
                     fused_dwn_batch_major, fused_dwn_packed)
from .ref import LayerStack, first_layer_wires


def forward(x, thresholds, mapping, tables, num_classes: int, *,
            config=None):
    """Whole-accelerator inference on the float datapath, one LUT layer:
    features -> (counts (B, classes) float32, idx (B,) int32).

    x (B, F) (a non-tensor goes to the CUDA card, which must be present);
    thresholds (F, T); mapping (m, n) wire indices into the F*T bits;
    tables (m, 2^n), cast to float32 as the reference's op does (finite
    values).  LUT l counts for class ``l // (m // num_classes)``; LUTs past
    the last whole group count for no class, as in the reference's op.
    ``idx`` is the first argmax (ties go to the lower class).  ``config``
    (a ``FusedConfig``) sets ``block_b`` and ``block_m``; without one the
    kernel's own defaults apply.  T is not padded and no one-hot matrix is
    built.  Raises ``ValueError`` on a wire outside [0, F*T).  One kernel
    launch on CUDA.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=resolve_device())
    x = x.to(torch.float32).contiguous()
    thresholds = torch.as_tensor(thresholds, device=x.device).to(
        torch.float32).contiguous()
    mapping = torch.as_tensor(mapping, device=x.device).to(
        torch.int32).contiguous()
    tables = torch.as_tensor(tables, device=x.device).to(
        torch.float32).contiguous()
    check_wires(mapping, thresholds.numel())
    if config is None:
        block_b, block_m = FUSED_DWN_BLOCK_B, FUSED_DWN_BLOCK_M
    else:
        block_b, block_m = config.block_b, config.block_m
    return fused_dwn(x, thresholds, mapping, tables, num_classes,
                     block_b=block_b, block_m=block_m)


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
    out-of-range wire, a malformed table; on a CUDA device, activations
    too wide for a block, :func:`kernel.check_activation_width`).
    """
    if not isinstance(mappings, (list, tuple)):
        mappings, tables = [mappings], [tables]
    thresholds = thresholds.to(torch.float32).contiguous()
    device = thresholds.device
    F, T = thresholds.shape
    if device.type == "cuda":
        check_activation_width(variant, F, T,
                               [mp.shape[0] for mp in mappings], num_classes)
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


__all__ = ["forward", "forward_packed", "make_forward_packed",
           "prepare_operands"]
