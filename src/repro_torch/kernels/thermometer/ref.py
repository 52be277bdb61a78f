"""Plain PyTorch versions of the two thermometer-encode kernels."""

from __future__ import annotations

import torch

from ...core.bitpack import pack_bits


def thermometer_plain(x: torch.Tensor,
                      thresholds: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32, thresholds (F, T) float32 -> (B, F, T) float32
    bits: ``x[b, f] > th[f, t]`` as 1.0 or 0.0 (NaN compares false)."""
    return (x[:, :, None] > thresholds[None]).to(torch.float32)


def thermometer_packed_plain(x: torch.Tensor,
                             thresholds: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32, thresholds (F, T) float32 -> (B, ceil(F*T/32))
    int64 words in [0, 2^32): bit ``f*T + t`` is ``x[b, f] > th[f, t]``
    (NaN compares false), LSB-first, zero pad bits in a ragged last word.
    """
    bits = x[:, :, None] > thresholds[None]
    return pack_bits(bits.reshape(x.shape[0], thresholds.numel()))


__all__ = ["thermometer_packed_plain", "thermometer_plain"]
