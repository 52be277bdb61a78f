"""Building blocks of the dense transformer, the port's counterpart of the
dense subset of the reference's ``repro.models.layers``.

Conventions, as in the reference:

* Activations and matrix products are bf16.  Norms, RoPE and the softmax
  run in float32 and cast back.  Score and probability products take bf16
  operands and accumulate in float32 (the reference's
  ``preferred_element_type``): the operands are cast to float32 first,
  which keeps every product of two bf16 values exact.
* Params are plain dicts of tensors.  Norm scales are float32.  Matrix
  weights come in two forms (each ``init_*`` takes ``dtype``): bf16 for
  serving, where the products see the reference's values at half the
  memory, and float32 for training, the reference's ``PARAM_DTYPE``
  master weights.  Every product casts its operands to bf16, so the
  gradients of a float32 leaf are float32.
* ``HeadLayout`` pads attention heads for tensor parallelism.  The port
  runs on one card (tp = 1), where the layout neither pads query heads
  nor repeats KV heads, so ``qkv_project`` does neither; the layout gives
  the query heads per KV head.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import round_up

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ---------------------------------------------------------------------------
# Head layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """Padded attention-head layout for a given tensor-parallel degree.

    q_padded   : query heads incl. dead padding (multiple of tp)
    kv_padded  : kv heads after activation-repeat (multiple of tp or == kv)
    slots      : q slots per original kv group (>= group size)
    """
    num_q: int
    num_kv: int
    q_padded: int
    kv_padded: int
    slots: int



def make_head_layout(num_q: int, num_kv: int, tp: int = 1) -> HeadLayout:
    """(q_padded, kv_padded, slots) such that every tensor-parallel shard
    owns whole query-head blocks aligned with the kv head they read (the
    reference's three regimes: MHA, kv divisible by tp, tp divisible by
    kv; anything else replicates kv)."""
    assert num_q % num_kv == 0, (num_q, num_kv)
    gs = num_q // num_kv
    if num_kv == num_q:                       # MHA: pad both 1:1
        qp = round_up(num_q, tp)
        return HeadLayout(num_q, num_kv, qp, qp, 1)
    if num_kv % tp == 0:                      # kv >= tp and divisible
        return HeadLayout(num_q, num_kv, num_q, num_kv, gs)
    if tp % num_kv == 0:                      # kv < tp: repeat kv
        r = tp // num_kv
        s = r * math.ceil(gs / r)
        return HeadLayout(num_q, num_kv, num_kv * s, tp, s)
    qp = round_up(num_q, tp)
    return HeadLayout(num_q, num_kv, qp, num_kv, qp // num_kv)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., :, None].float() * inv                # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=PARAM_DTYPE,
                       device=device) * std


def init_attention(gen: torch.Generator, d_model: int, layout: HeadLayout,
                   head_dim: int, *, qk_norm: bool = False, device=None,
                   dtype: torch.dtype = COMPUTE_DTYPE):
    """Attention params in the padded layout, the reference's stds, the
    matrices in ``dtype``.  Dead q heads (slots beyond the real group
    size) are zero, including their o-proj rows."""
    std = d_model ** -0.5
    H, K, s = layout.q_padded, layout.num_kv, layout.slots
    gs = layout.num_q // layout.num_kv
    heads = torch.arange(H, device=device)
    if layout.num_kv == layout.num_q:          # MHA padding: first num_q alive
        alive = (heads < layout.num_q).to(PARAM_DTYPE)
    else:                                      # GQA: slot-in-group >= gs dead
        alive = ((heads % s) < gs).to(PARAM_DTYPE)
    cd = dtype
    p = {
        "wq": (_normal(gen, (d_model, H, head_dim), std, device)
               * alive[None, :, None]).to(cd),
        "wk": _normal(gen, (d_model, K, head_dim), std, device).to(cd),
        "wv": _normal(gen, (d_model, K, head_dim), std, device).to(cd),
        "wo": (_normal(gen, (H, head_dim, d_model), std, device)
               * alive[:, None, None]).to(cd),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=PARAM_DTYPE, device=device)
        p["k_norm"] = torch.ones((head_dim,), dtype=PARAM_DTYPE, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, *out) -> (B, S, *out), bf16."""
    out = x.to(COMPUTE_DTYPE) @ w.reshape(w.shape[0], -1).to(COMPUTE_DTYPE)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def qkv_project(p, x: torch.Tensor, *, positions: torch.Tensor | None,
                rope_theta: float | None, qk_norm_eps: float = 1e-6):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, K, hd) in bf16 (the
    reference's at tp = 1, where its padded layout repeats and pads
    nothing)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], qk_norm_eps)
        k = rms_norm(k, p["k_norm"], qk_norm_eps)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      layout: HeadLayout, *, causal: bool,
                      kv_chunk: int = 1024,
                      scores_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Online-softmax attention over KV chunks, plain PyTorch (the
    reference's ``attn_impl="masked"`` path).

    q: (B, Sq, Hp, hd); k/v: (B, Skv, Kp, hd) (already padded layout).
    ``scores_dtype`` is the type the score product Q K^T is rounded to
    before it is taken back to float32 and scaled (the reference's
    ``preferred_element_type``): float32, or bf16 for ``attn_scores_bf16``.
    Returns (B, Sq, Hp, hd) bf16.  The last chunk is taken short instead
    of zero-padded: its missing keys are masked in the reference, so the
    two agree.
    """
    B, Sq, Hp, hd = q.shape
    Skv = k.shape[1]
    Kp = layout.kv_padded
    g = Hp // Kp
    scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(B, Sq, Kp, g, hd).to(COMPUTE_DTYPE).float()
    q_pos = torch.arange(Sq, device=dev)
    o = torch.zeros((B, Sq, Kp, g, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, Kp, g), float("-inf"), device=dev)
    l = torch.zeros((B, Sq, Kp, g), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, kv_chunk):
        kci = k[:, c0:c0 + kv_chunk].to(COMPUTE_DTYPE).float()
        vci = v[:, c0:c0 + kv_chunk].to(COMPUTE_DTYPE).float()
        kv_pos = c0 + torch.arange(kci.shape[1], device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kci).to(
            scores_dtype).float() * scale
        if causal:
            mask = (q_pos[:, None] >= kv_pos[None, :])[None, :, None, None]
            s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard all-masked rows (m_new = -inf): keep them neutral
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if causal:
            p = p.masked_fill(~mask, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(COMPUTE_DTYPE).float(), vci)
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.reshape(B, Sq, Hp, hd).to(COMPUTE_DTYPE)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, layout: HeadLayout, *,
                     cur_len: int) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, Hp, hd); caches: (B, Skv, Kp, hd); ``cur_len`` valid cache
    entries (the new token's k/v already written).  Returns (B, 1, Hp, hd)
    bf16.
    """
    B, _, Hp, hd = q.shape
    Skv, Kp = k_cache.shape[1], k_cache.shape[2]
    g = Hp // Kp
    qg = q.reshape(B, Kp, g, hd).to(COMPUTE_DTYPE).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg,
                     k_cache.to(COMPUTE_DTYPE).float()) * (hd ** -0.5)
    valid = torch.arange(Skv, device=q.device) < cur_len
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgc,bckd->bkgd", p.to(COMPUTE_DTYPE).float(),
                     v_cache.to(COMPUTE_DTYPE).float())
    return o.reshape(B, 1, Hp, hd).to(COMPUTE_DTYPE)


def attn_output(p, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, Hp, hd) -> (B, S, D) bf16."""
    B, S = o.shape[:2]
    wo = p["wo"]
    return (o.reshape(B, S, -1).to(COMPUTE_DTYPE)
            @ wo.reshape(-1, wo.shape[-1]).to(COMPUTE_DTYPE))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, *,
                device=None, dtype: torch.dtype = COMPUTE_DTYPE):
    std_in, std_out = d_model ** -0.5, d_ff ** -0.5
    cd = dtype
    return {"w_gate": _normal(gen, (d_model, d_ff), std_in, device).to(cd),
            "w_up": _normal(gen, (d_model, d_ff), std_in, device).to(cd),
            "w_down": _normal(gen, (d_ff, d_model), std_out, device).to(cd)}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    cd = COMPUTE_DTYPE
    xc = x.to(cd)
    g = xc @ p["w_gate"].to(cd)
    u = xc @ p["w_up"].to(cd)
    h = torch.nn.functional.silu(g.float()).to(cd) * u
    return h @ p["w_down"].to(cd)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab_padded: int, d_model: int, *,
                   device=None, dtype: torch.dtype = COMPUTE_DTYPE):
    return {"table": _normal(gen, (vocab_padded, d_model), 0.01,
                             device).to(dtype)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens].to(COMPUTE_DTYPE)


def init_unembed(gen: torch.Generator, d_model: int, vocab_padded: int, *,
                 device=None, dtype: torch.dtype = COMPUTE_DTYPE):
    return {"w": _normal(gen, (d_model, vocab_padded), d_model ** -0.5,
                         device).to(dtype)}


def unembed(p, x: torch.Tensor, cols: int | None = None) -> torch.Tensor:
    """x (..., D) -> logits (..., Vp) bf16; with ``cols``, only the first
    ``cols`` vocabulary columns (the same dot products)."""
    w = p["w"] if cols is None else p["w"][:, :cols]
    return x.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       vocab_real: int, z_loss: float = 1e-4
                       ) -> torch.Tensor:
    """Next-token cross-entropy with padded-vocab masking and z-loss, the
    reference's expression.

    logits: (B, S, Vp) (bf16 ok); labels: (B, S) integer (-1 = ignore).
    Returns the float32 mean over the labelled positions of
    ``logsumexp - picked`` plus ``z_loss`` times the mean of
    ``logsumexp ** 2``.
    """
    Vp = logits.shape[-1]
    lf = logits.float()
    if vocab_real < Vp:
        mask = torch.arange(Vp, device=lf.device) < vocab_real
        lf = torch.where(mask, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    labels = labels.to(lf.device)
    lab = torch.clamp(labels, 0, Vp - 1).long()
    picked = torch.take_along_dim(lf, lab[..., None], dim=-1)[..., 0]
    nll = lse - picked
    valid = (labels >= 0).float()
    nll = nll * valid
    z = (lse ** 2) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    return (nll.sum() + z_loss * z.sum()) / denom


__all__ = [
    "COMPUTE_DTYPE", "HeadLayout", "PARAM_DTYPE", "apply_rope",
    "attention_chunked", "attention_decode", "attn_output",
    "cross_entropy_loss", "embed",
    "init_attention", "init_embedding", "init_swiglu", "init_unembed",
    "make_head_layout", "qkv_project", "rms_norm", "rope_frequencies",
    "swiglu", "unembed",
]
