"""Public op of the flash-attention kernel (the reference's
``flash_attn/ops.py:attend``), in the model's layout."""

from __future__ import annotations

import torch

from .kernel import flash_attention
from .ref import attention_ref


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, block: int = 512) -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, S, K, hd) with H % K == 0 (GQA) ->
    (B, S, H, hd) in q's dtype.  One kernel launch on CUDA.

    The kernel reads key/value head h // (H // K) for query head h, so KV
    is never repeated, and masks keys at or past S, so S needs no padding
    (the reference repeats KV and pads S to a block multiple; unmasked,
    its zero keys enter the non-causal softmax).  ``block`` is accepted
    for the reference's signature and changes nothing: the kernel picks
    its own tiles.
    """
    del block
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal)


__all__ = ["attend", "attention_ref"]
