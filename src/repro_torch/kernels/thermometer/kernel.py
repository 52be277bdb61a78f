"""Launch wrappers of the two thermometer-encode CUDA kernels
(``csrc/thermometer.cu``): ``thermometer_encode`` (float32 bits) and
``thermometer_encode_packed`` (packed words), the counterparts of the
reference's Pallas kernels of the same names.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import torch

from ...core.bitpack import words_for_bits
from .._launch import I, LaunchCounts, P, bind, device_type, expect, launch
from .ref import thermometer_packed_plain, thermometer_plain

LIBRARY = "thermometer"
_COUNTS = LaunchCounts("thermometer_encode", "thermometer_encode_packed")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"thermometer_encode_launch": [P, P, I, I, I, P, P],
               "thermometer_encode_packed_launch": [P, P, I, I, I, P, P]}


def _check(x: torch.Tensor, thresholds: torch.Tensor):
    """(B, F, T) of valid operands on ``x``'s device; raises otherwise."""
    dev = x.device
    expect(x, "x", torch.float32, 2, dev)
    expect(thresholds, "thresholds", torch.float32, 2, dev)
    B, F = x.shape
    F_th, T = thresholds.shape
    if F_th != F:
        raise ValueError(f"x has {F} features, thresholds {F_th}")
    return B, F, T


def thermometer_encode(x: torch.Tensor,
                       thresholds: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32, thresholds (F, T) float32 -> (B, F, T) float32:
    1.0 where ``x[b, f] > th[f, t]``, else 0.0 (NaN compares false).
    """
    if device_type(x, "thermometer_encode") == "cpu":
        return thermometer_plain(x, thresholds)
    B, F, T = _check(x, thresholds)
    out = torch.empty((B, F, T), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "thermometer_encode", x.device,
           lambda stream: lib.thermometer_encode_launch(
               x.data_ptr(), thresholds.data_ptr(), B, F, T, out.data_ptr(),
               stream), _COUNTS)
    return out


def thermometer_encode_packed(x: torch.Tensor,
                              thresholds: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32, thresholds (F, T) float32 -> (B, ceil(F*T/32))
    words: bit ``f*T + t`` is ``x[b, f] > th[f, t]``, LSB-first, zero pad
    bits.  int32 bit patterns on CUDA, int64 carriers on the CPU.
    """
    if device_type(x, "thermometer_encode_packed") == "cpu":
        return thermometer_packed_plain(x, thresholds)
    B, F, T = _check(x, thresholds)
    dev = x.device
    out = torch.empty((B, words_for_bits(F * T)), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "thermometer_encode_packed", dev,
           lambda stream: lib.thermometer_encode_packed_launch(
               x.data_ptr(), thresholds.data_ptr(), B, F, T, out.data_ptr(),
               stream), _COUNTS)
    return out


__all__ = ["launch_counts", "reset_launch_counts", "thermometer_encode",
           "thermometer_encode_packed"]
