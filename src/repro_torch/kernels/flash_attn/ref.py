"""Plain PyTorch version of the flash-attention kernel (the reference's
``flash_attn/ref.py:attention_ref``): full softmax attention in float32,
output in q's dtype."""

from __future__ import annotations

import torch


def _attention_bsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """q/k/v (BH, S, hd) -> (BH, S, hd), float32 inside."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) / (q.shape[-1] ** 0.5)
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Attention over every key (and only keys at or before the query
    when ``causal``), scale ``hd ** -0.5``.

    Takes the reference's layout, q/k/v (BH, S, hd), or the model's
    grouped-query layout, q (B, S, H, hd) with k/v (B, S, K, hd) and
    H % K == 0, where query head h reads key/value head h // (H // K).
    Returns q's shape and dtype.
    """
    if q.dim() == 3:
        return _attention_bsd(q, k, v, causal)
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, hd)  # noqa: E731
    out = _attention_bsd(fold(q), fold(k.repeat_interleave(g, dim=2)),
                         fold(v.repeat_interleave(g, dim=2)), causal)
    return out.reshape(B, H, S, hd).transpose(1, 2)


__all__ = ["attention_ref"]
