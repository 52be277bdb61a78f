"""Launch wrapper of the flash-attention CUDA kernel
(``csrc/flash_attn.cu``), the counterpart of the reference's Pallas
kernel ``flash_attention``.

For tensors on the CPU the wrapper runs its plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises — it never falls back.  Each
launch adds one to the kernel's count in :func:`launch_counts`.
"""

from __future__ import annotations

import torch

from .._launch import I, LaunchCounts, P, bind, device_type, expect, launch
from .ref import attention_ref

LIBRARY = "flash_attn"
_COUNTS = LaunchCounts("flash_attention")
#: kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts = _COUNTS.get
reset_launch_counts = _COUNTS.reset
_SIGNATURES = {"flash_attn_launch": [P, P, P, P, I, I, I, I, I, I, P]}
#: head dims the kernel is instantiated for (qwen3-8b's and its reduced
#: variant's); the plain version takes any
HEAD_DIMS = (16, 128)
#: the grid's y extent: the hd-16 instance puts batch x query heads on
#: blockIdx.y, the hd-128 one its 128-row query blocks (batch x query heads
#: go on blockIdx.x, which no real shape fills)
_MAX_GRID_Y = 65535
_HD128_ROWS = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention with scale ``hd ** -0.5``, causal or over every
    key, float32 inside, output in q's dtype and shape.

    Layouts: the reference's q/k/v (BH, S, hd), or the model's q (B, S, H,
    hd) with k/v (B, S, K, hd), H % K == 0 — query head h reads
    key/value head h // (H // K) with no repeat.  On CUDA the operands
    are contiguous bf16 with hd in :data:`HEAD_DIMS`; anything else raises
    ``ValueError``.
    """
    if device_type(q, "flash_attention") == "cpu":
        return attention_ref(q, k, v, causal=causal)
    dev = q.device
    ndim = q.dim()
    if ndim not in (3, 4):
        raise ValueError(f"q must be 3-d (BH, S, hd) or 4-d (B, S, H, hd), "
                         f"got {ndim}-d")
    for name, t in (("q", q), ("k", k), ("v", v)):
        expect(t, name, torch.bfloat16, ndim, dev)
    if ndim == 3:           # (BH, S, hd): one head per row of the batch
        q4, k4, v4 = (t.unsqueeze(2) for t in (q, k, v))
    else:
        q4, k4, v4 = q, k, v
    B, S, H, hd = q4.shape
    KH = k4.shape[2]
    if (k4.shape != (B, S, KH, hd) or v4.shape != k4.shape or KH < 1
            or H % KH):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not form grouped-query "
                         f"attention (k and v alike, heads dividing q's)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} has no kernel instance; the "
                         f"kernel takes {HEAD_DIMS}")
    if hd == 16 and B * H > _MAX_GRID_Y:
        raise ValueError(f"batch x heads = {B * H} exceeds {_MAX_GRID_Y} "
                         f"at head_dim 16")
    if hd == 128 and S > _HD128_ROWS * _MAX_GRID_Y:
        raise ValueError(f"S = {S} exceeds {_HD128_ROWS * _MAX_GRID_Y} at "
                         f"head_dim 128")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = bind(LIBRARY, _SIGNATURES)
    launch(lib, LIBRARY, "flash_attention", dev,
           lambda stream: lib.flash_attn_launch(
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
               S, H, KH, hd, int(causal), stream), _COUNTS)
    return out


__all__ = ["HEAD_DIMS", "flash_attention", "launch_counts",
           "reset_launch_counts"]
