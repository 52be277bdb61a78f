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
#: flash_attn_mma_launch runs the first design at hd 64 and 96, for a
#: same-call comparison on the card only: the wrapper never calls it
_SIGNATURES = {fn: [P, P, P, P, I, I, I, I, I, I, P]
               for fn in ("flash_attn_launch", "flash_attn_mma_launch")}
#: head dims the kernel is instantiated for: 64 (granite-moe), 96
#: (phi3-mini) and 128 (qwen3-8b, qwen3-14b, qwen2-7b, mixtral) on the
#: Hopper design, 16 (the reduced archs), 32 and 256 on the mma.sync one;
#: any other head dim up to :data:`MAX_HEAD_DIM` runs on the smallest
#: instance above it (:func:`instance_for`), the plain version on any
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: widest head dim the kernel takes (its largest instance)
MAX_HEAD_DIM = 256
#: the Hopper design's grid has one block a (128-row query block, b, h),
#: all on blockIdx.x; the mma.sync design folds batch x heads past
#: grid.y's 65,535 into grid.x
_MAX_GRID_X = 2 ** 31 - 1
_WS_ROWS = 128


def instance_for(hd: int) -> tuple[int, str]:
    """(instance head dim, design) that runs head dim ``hd`` (1 to
    :data:`MAX_HEAD_DIM`), as ``instance_for`` in the source: the
    smallest instance at or above ``hd``; the Hopper design ("tma") at
    64, 96 and 128 where ``hd`` is a multiple of 8 (TMA's rows are whole
    16-byte units), else the mma.sync design ("mma") at 16, 32, 64, 96 or
    256.  The columns past ``hd`` are zeros in shared memory and the
    scale is ``hd ** -0.5`` either way."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is outside [1, {MAX_HEAD_DIM}]")
    if hd <= 32:
        return (16 if hd <= 16 else 32), "mma"
    tma = hd % 8 == 0
    for inst in (64, 96, 128):
        if hd <= inst and (tma or inst != 128):
            return inst, ("tma" if tma else "mma")
    return 256, "mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention with scale ``hd ** -0.5``, causal or over every
    key, float32 inside, output in q's dtype and shape.

    Layouts: the reference's q/k/v (BH, S, hd), or the model's q (B, S, H,
    hd) with k/v (B, S, K, hd), H % K == 0 — query head h reads
    key/value head h // (H // K) with no repeat.  On CUDA the operands
    are contiguous bf16 with 1 <= hd <= :data:`MAX_HEAD_DIM`
    (:func:`instance_for`); anything else raises ``ValueError``.
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
    _, design = instance_for(hd)
    if design == "tma" and B * H * -(-S // _WS_ROWS) > _MAX_GRID_X:
        raise ValueError(f"batch x heads x query blocks of {_WS_ROWS} rows "
                         f"exceeds {_MAX_GRID_X} at head_dim {hd}")
    if hd % 8 == 0 and any(t.data_ptr() % 16 for t in (q, k, v)):
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


__all__ = ["HEAD_DIMS", "MAX_HEAD_DIM", "flash_attention", "instance_for",
           "launch_counts", "reset_launch_counts"]
