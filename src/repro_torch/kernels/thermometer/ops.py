"""Public ops of the thermometer encode (the reference's
``thermometer/ops.py``: ``encode`` and ``encode_packed``)."""

from __future__ import annotations

import torch

from ...core.bitpack import PackedBits
from ...device import resolve_device
from .kernel import thermometer_encode, thermometer_encode_packed


def _operands(x, thresholds):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=resolve_device())
    x = x.to(torch.float32).contiguous()
    thresholds = torch.as_tensor(thresholds, device=x.device).to(
        torch.float32).contiguous()
    return x, thresholds


def encode(x, thresholds, *, flatten: bool = True) -> torch.Tensor:
    """Thermometer-encode to float32 bits.

    x (B, F) and thresholds (F, T), as float32 tensors (anything else is
    converted; a non-tensor ``x`` goes to the CUDA card, which must be
    present).  Returns (B, F*T) float32 {0,1} with bit ``f*T + t`` equal
    to ``x[b, f] > thresholds[f, t]``, or (B, F, T) with
    ``flatten=False``.  T is not padded (the reference pads it to 128
    lanes inside its op and slices the padding off).  One kernel launch
    on CUDA.
    """
    x, thresholds = _operands(x, thresholds)
    bits = thermometer_encode(x, thresholds)
    return bits.reshape(x.shape[0], thresholds.numel()) if flatten else bits


def encode_packed(x, thresholds) -> PackedBits:
    """Thermometer-encode straight into packed words.

    x (B, F) and thresholds (F, T), as float32 tensors (anything else is
    converted; a non-tensor ``x`` goes to the CUDA card, which must be
    present).  Bit ``f*T + t`` of the flat bit vector is
    ``x[b, f] > thresholds[f, t]``.  Any F*T: a ragged last word has zero
    pad bits, where the reference falls back to its jnp oracle.  Returns
    ``PackedBits`` of F*T bits: int32 bit patterns on CUDA (one kernel
    launch), int64 carriers on the CPU.
    """
    x, thresholds = _operands(x, thresholds)
    return PackedBits(thermometer_encode_packed(x, thresholds),
                      thresholds.numel())


__all__ = ["encode", "encode_packed"]
