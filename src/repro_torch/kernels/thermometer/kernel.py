"""Launch wrapper of the packed thermometer-encode CUDA kernel
(``csrc/thermometer.cu``), the counterpart of the reference's Pallas
``thermometer_encode_packed``.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import torch

from ...core.bitpack import words_for_bits
from .._launch import I, LaunchCounts, P, bind, device_type, expect, launch
from .ref import thermometer_packed_plain

LIBRARY = "thermometer"
_COUNTS = LaunchCounts("thermometer_encode_packed")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"thermometer_encode_packed_launch": [P, P, I, I, I, P, P]}


def thermometer_encode_packed(x: torch.Tensor,
                              thresholds: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32, thresholds (F, T) float32 -> (B, ceil(F*T/32))
    words: bit ``f*T + t`` is ``x[b, f] > th[f, t]``, LSB-first, zero pad
    bits.  int32 bit patterns on CUDA, int64 carriers on the CPU.
    """
    if device_type(x, "thermometer_encode_packed") == "cpu":
        return thermometer_packed_plain(x, thresholds)
    dev = x.device
    expect(x, "x", torch.float32, 2, dev)
    expect(thresholds, "thresholds", torch.float32, 2, dev)
    B, F = x.shape
    F_th, T = thresholds.shape
    if F_th != F:
        raise ValueError(f"x has {F} features, thresholds {F_th}")
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


__all__ = ["launch_counts", "reset_launch_counts",
           "thermometer_encode_packed"]
