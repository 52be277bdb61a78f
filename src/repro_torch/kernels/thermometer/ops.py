"""Public op of the packed thermometer encode (the reference's
``thermometer/ops.py:encode_packed``)."""

from __future__ import annotations

import torch

from ...core.bitpack import PackedBits
from ...device import resolve_device
from .kernel import thermometer_encode_packed


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
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=resolve_device())
    x = x.to(torch.float32).contiguous()
    thresholds = torch.as_tensor(thresholds, device=x.device).to(
        torch.float32).contiguous()
    return PackedBits(thermometer_encode_packed(x, thresholds),
                      thresholds.numel())


__all__ = ["encode_packed"]
