"""Building blocks of the LM zoo's models, the port's counterpart of the
reference's ``repro.models.layers``: norms (RMS and layer norm), RoPE,
attention, the SwiGLU and GELU MLPs, the MoE, the depthwise causal
convolution of the SSM and hybrid blocks, embedding and loss, and the
carrying of the reference's param trees across (:func:`tree_from_numpy`).

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
* ``HeadLayout`` pads attention heads for a tensor-parallel degree tp,
  as the reference's does: dead query heads (zero weights and zero
  o-projection rows) pad the query heads, and ``qkv_project`` repeats the
  KV heads' activations (or pads them with zero heads) to the layout's
  ``kv_padded``, so every shard owns whole query blocks with the KV
  head they read.  At tp = 1 the layout pads and repeats nothing.
* Tensor parallelism (``models.parallel``): on a rank of a ``DeviceMesh``
  whose "model" axis splits the params, each function takes this rank's
  shards and calls the collectives the reference's hints imply
  (``sharding.collectives``): the query heads, the MLP's hidden dim, the
  experts (or their hidden dim) and the vocabulary are split; a function
  learns that its leaf is split by comparing the leaf's shape with the
  full size its caller passes (``layout``, ``d_ff``, ``vocab``).  The
  SSM and hybrid blocks take the channels a rank works on from each leaf
  with :func:`model_part`, whether the partitioner split the leaf or a
  divisibility fallback left it whole, and normalise over a model-split
  dimension with :func:`rms_norm_model`.  Without a mesh every
  collective is the identity: one device runs the reference's
  arithmetic at any tp.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import round_up
from ..sharding import collectives as C
from ..sharding.partition import logical

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

    @property
    def kv_repeat(self) -> int:
        return self.kv_padded // self.num_kv


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


def local_layout(layout: HeadLayout, n: int) -> HeadLayout:
    """A model rank's share of ``layout`` on n ranks: ``q_padded / n``
    query heads over ``kv_padded / n`` KV heads; where n does not divide
    the KV heads (the layout kept them whole), one KV head a local query
    head, each the copy its query head reads (:func:`local_kv`)."""
    if n == 1:
        return layout
    hl = layout.q_padded // n
    kl = layout.kv_padded // n if layout.kv_padded % n == 0 else hl
    return HeadLayout(layout.num_q, layout.num_kv, hl, kl, hl // kl)


def local_kv(t: torch.Tensor, layout: HeadLayout, rank: int,
             n: int) -> torch.Tensor:
    """k or v (B, S, kv_padded, hd) laid out at ``layout`` -> the KV heads
    model rank ``rank`` of n reads (``local_layout(layout, n)``'s):
    its slice where n divides them, else the head of each of its query
    heads."""
    if n == 1:
        return t
    if layout.kv_padded % n == 0:
        kl = layout.kv_padded // n
        return t[:, :, rank * kl:(rank + 1) * kl]
    hl, g = layout.q_padded // n, layout.q_padded // layout.kv_padded
    heads = torch.arange(rank * hl, (rank + 1) * hl, device=t.device) // g
    return t.index_select(2, heads)


def _split(local: int, full: int, n: int, what: str) -> bool:
    """Whether a leaf whose dim holds ``local`` of ``full`` entries is
    split over the n model ranks (``ValueError`` where it is neither whole
    nor an n-th)."""
    if local == full:
        return False
    if local * n != full:
        raise ValueError(f"{what}: {local} of {full} entries on one of {n} "
                         f"model ranks: the params were laid out for "
                         f"another mesh")
    return True


def model_part(t: torch.Tensor, full: int, dim: int, split: bool,
               what: str) -> torch.Tensor:
    """The entries of leaf ``t`` along ``dim`` (``full`` of them in the
    whole leaf) that this model rank works on: with ``split`` its n-th,
    the leaf's own chunk where the partitioner split it and cut from the
    whole leaf where a fallback kept it whole (each rank's gradient then
    covers its own chunk: a partial gradient ``models.parallel`` sums);
    without ``split`` all of them, gathered where the leaf holds an n-th
    (every rank then runs the whole and holds the whole gradient)."""
    n = C.model_size()
    held = _split(t.shape[dim], full, n, what)
    if split:
        if held:
            return t
        k = full // n
        return t.narrow(dim, C.model_rank() * k, k)
    return C.gather_from_model(t, dim) if held else t


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rms_norm_model(x: torch.Tensor, scale: torch.Tensor, full: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` of a dimension of ``full`` channels of which x
    (and ``scale``) hold this model rank's share: the float32 sum of
    squares of the local channels summed over the model ranks (forward
    and backward, ``collectives.sum_over_model``) before the mean.  With
    every channel here it is :func:`rms_norm`."""
    if x.shape[-1] == full:
        return rms_norm(x, scale, eps)
    xf = x.float()
    var = C.sum_over_model((xf * xf).sum(dim=-1, keepdim=True)) / full
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with scale and bias, in float32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def init_layer_norm(d: int, *, device=None):
    """Float32 scale ones and bias zeros, as the reference's."""
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


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

def init_generator(device, seed: int) -> torch.Generator:
    """The init's generator: on ``device``, seeded with ``seed``; on the
    ``meta`` device (shapes only, nothing is drawn) one on the CPU, which
    draws on ``meta`` accept."""
    dev = torch.device(device)
    return torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(seed)


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=PARAM_DTYPE,
                       device=device) * std


def init_attention(gen: torch.Generator, d_model: int, layout: HeadLayout,
                   head_dim: int, *, qkv_bias: bool = False,
                   qk_norm: bool = False, out_bias: bool = False,
                   device=None, dtype: torch.dtype = COMPUTE_DTYPE):
    """Attention params in the padded layout, the reference's stds, the
    matrices (and the q/k/v and output biases, zero as the reference's) in
    ``dtype``.  Dead q heads (slots beyond the real group size) are zero,
    including their o-proj rows."""
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
    if qkv_bias:
        p["bq"] = torch.zeros((H, head_dim), dtype=cd, device=device)
        p["bk"] = torch.zeros((K, head_dim), dtype=cd, device=device)
        p["bv"] = torch.zeros((K, head_dim), dtype=cd, device=device)
    if out_bias:
        p["bo"] = torch.zeros((d_model,), dtype=cd, device=device)
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=PARAM_DTYPE, device=device)
        p["k_norm"] = torch.ones((head_dim,), dtype=PARAM_DTYPE, device=device)
    return p


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, *out) -> (B, S, *out), bf16."""
    out = x.to(COMPUTE_DTYPE) @ w.reshape(w.shape[0], -1).to(COMPUTE_DTYPE)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def pad_kv(t: torch.Tensor, layout: HeadLayout | None) -> torch.Tensor:
    """k or v (B, S, K, hd) at the true KV head count -> (B, S, kv_padded,
    hd): each head repeated ``kv_repeat`` times in place (head j becomes
    heads [j r, (j + 1) r)), then zero heads up to ``kv_padded`` (MHA's
    dead heads), as the reference's ``qkv_project`` lays them out.  The
    copies share one weight, so GQA reads what it would unrepeated."""
    if layout is None:
        return t
    if layout.kv_repeat > 1:
        t = t.repeat_interleave(layout.kv_repeat, dim=2)
    if t.shape[2] < layout.kv_padded:
        t = torch.nn.functional.pad(
            t, (0, 0, 0, layout.kv_padded - t.shape[2]))
    return t


def qkv_project(p, x: torch.Tensor, layout: HeadLayout | None = None, *,
                positions: torch.Tensor | None, rope_theta: float | None,
                qk_norm_eps: float = 1e-6):
    """x (B, S, D) -> q (B, S, Hp, hd), k/v (B, S, Kp, hd) in bf16, the
    reference's: the biases, where there are any, added in bf16 before the
    qk-norm and RoPE; then k and v laid out at ``layout`` (:func:`pad_kv`;
    ``None`` leaves the true KV heads).  The query heads are the params'
    (padded when they were made at tp > 1); a ``layout`` that wants
    another count raises ``ValueError``.  On a model rank whose ``wq``
    holds an n-th of the query heads, q holds those and k/v the KV heads
    they read (``local_layout(layout, n)``); x enters through
    Megatron's f."""
    split = heads_split(p, layout)
    if split:
        x = C.copy_to_model(x)
    q, k, v = proj(x, p["wq"]), proj(x, p["wk"]), proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(COMPUTE_DTYPE)
        k = k + p["bk"].to(COMPUTE_DTYPE)
        v = v + p["bv"].to(COMPUTE_DTYPE)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], qk_norm_eps)
        k = rms_norm(k, p["k_norm"], qk_norm_eps)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k, v = pad_kv(k, layout), pad_kv(v, layout)
    if split:
        k, v = model_kv(k, layout), model_kv(v, layout)
    return q, k, v


def heads_split(p, layout: HeadLayout | None) -> bool:
    """Whether ``p["wq"]`` holds this model rank's share of ``layout``'s
    query heads (``ValueError`` for a count that is neither that nor all
    of them)."""
    if layout is None:
        return False
    heads = p["wq"].shape[1]
    if heads not in (layout.q_padded, layout.q_padded // C.model_size()):
        raise ValueError(
            f"the params hold {heads} query heads; the head "
            f"layout wants {layout.q_padded}: make the params at the tp the "
            f"model runs at")
    return heads != layout.q_padded


def model_kv(t: torch.Tensor, layout: HeadLayout) -> torch.Tensor:
    """k or v laid out at ``layout`` -> the KV heads this model rank's
    query heads read (:func:`local_kv` on the ambient mesh)."""
    return local_kv(t, layout, C.model_rank(), C.model_size())


def _attn_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                layout: HeadLayout, *, causal: bool, window: int | None = None,
                q_offset: int = 0, kv_offset: int = 0, kv_chunk: int = 1024,
                scores_dtype: torch.dtype = torch.float32):
    """The online softmax over KV chunks, unnormalised: (o (B, Sq, Kp, g,
    hd), m, l (B, Sq, Kp, g)) float32, so that parts over disjoint KV
    ranges combine (:func:`_combine_parts`).

    q: (B, Sq, Hp, hd) at positions ``q_offset + i``; k/v: (B, Skv, Kp,
    hd) at ``kv_offset + j`` (already padded layout).  A key is masked
    when it lies after the query (``causal``) or ``window`` or more
    positions before it.  ``scores_dtype`` is the type the score product
    Q K^T is rounded to before it is taken back to float32 and scaled (the
    reference's ``preferred_element_type``): float32, or bf16 for
    ``attn_scores_bf16``.  The last chunk is taken short instead of
    zero-padded: its missing keys are masked in the reference, so the two
    agree.
    """
    B, Sq, Hp, hd = q.shape
    Skv = k.shape[1]
    Kp = layout.kv_padded
    g = Hp // Kp
    scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(B, Sq, Kp, g, hd).to(COMPUTE_DTYPE).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    o = torch.zeros((B, Sq, Kp, g, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, Kp, g), float("-inf"), device=dev)
    l = torch.zeros((B, Sq, Kp, g), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, kv_chunk):
        kci = k[:, c0:c0 + kv_chunk].to(COMPUTE_DTYPE).float()
        vci = v[:, c0:c0 + kv_chunk].to(COMPUTE_DTYPE).float()
        kv_pos = kv_offset + c0 + torch.arange(kci.shape[1], device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kci).to(
            scores_dtype).float() * scale
        mask = None
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            near = q_pos[:, None] - kv_pos[None, :] < window
            mask = near if mask is None else mask & near
        if mask is not None:
            mask = mask[None, :, None, None]
            s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard all-masked rows (m_new = -inf): keep them neutral
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(COMPUTE_DTYPE).float(), vci)
        m = m_new
    return o, m, l


def _combine_parts(a, b):
    """Merge two online-softmax parts over disjoint KV ranges."""
    o1, m1, l1 = a
    o2, m2, l2 = b
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    a1 = torch.where(torch.isfinite(m1), torch.exp(m1 - m_safe), 0.0)
    a2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m_safe), 0.0)
    return (o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2)


def _normalise(parts, shape) -> torch.Tensor:
    o, _, l = parts
    return (o / torch.clamp(l[..., None], min=1e-30)).reshape(shape).to(
        COMPUTE_DTYPE)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      layout: HeadLayout, *, causal: bool,
                      window: int | None = None, kv_chunk: int = 1024,
                      scores_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Online-softmax attention over KV chunks, plain PyTorch (the
    reference's ``attn_impl="masked"`` path), with an optional sliding
    ``window``: q: (B, Sq, Hp, hd); k/v: (B, Skv, Kp, hd) -> (B, Sq, Hp,
    hd) bf16.  Arguments as :func:`_attn_parts`."""
    return _normalise(_attn_parts(q, k, v, layout, causal=causal,
                                  window=window, kv_chunk=kv_chunk,
                                  scores_dtype=scores_dtype), q.shape)


def attention_causal_tri(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         layout: HeadLayout, *, kv_chunk: int = 1024,
                         leaf: int = 4096,
                         scores_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Block-triangular causal attention (the reference's
    ``attn_impl="tri"``): a sequence longer than ``leaf`` splits in half;
    the block above the diagonal is never computed, the block below it is
    dense (no mask) and the two diagonal blocks recurse.  Parts merge with
    the online-softmax algebra, so the result is the chunked path's up to
    the order of the sums."""

    def rec(q_, k_, v_, off):
        Sq = q_.shape[1]
        if Sq <= leaf:
            return _attn_parts(q_, k_, v_, layout, causal=True,
                               q_offset=off, kv_offset=off,
                               kv_chunk=min(kv_chunk, Sq),
                               scores_dtype=scores_dtype)
        half = Sq // 2
        top = rec(q_[:, :half], k_[:, :half], v_[:, :half], off)
        cross = _attn_parts(q_[:, half:], k_[:, :half], v_[:, :half],
                            layout, causal=False, q_offset=off + half,
                            kv_offset=off, kv_chunk=kv_chunk,
                            scores_dtype=scores_dtype)
        diag = rec(q_[:, half:], k_[:, half:], v_[:, half:], off + half)
        bottom = _combine_parts(cross, diag)
        return tuple(torch.cat([t, b], dim=1) for t, b in zip(top, bottom))

    return _normalise(rec(q, k, v, 0), q.shape)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, layout: HeadLayout, *,
                     cur_len: int, window: int | None = None
                     ) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, Hp, hd); caches: (B, Skv, Kp, hd); ``cur_len`` tokens written
    so far (the new token's k/v already written).  Without a window the
    first ``cur_len`` slots are valid.  With one the cache is a ring whose
    slot ``p % Skv`` holds position p (the reference's semantics): slots
    below ``cur_len`` and at most ``window`` back are valid, and every slot
    once the ring has wrapped.  Returns (B, 1, Hp, hd) bf16.
    """
    B, _, Hp, hd = q.shape
    Skv, Kp = k_cache.shape[1], k_cache.shape[2]
    g = Hp // Kp
    qg = q.reshape(B, Kp, g, hd).to(COMPUTE_DTYPE).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg,
                     k_cache.to(COMPUTE_DTYPE).float()) * (hd ** -0.5)
    slots = torch.arange(Skv, device=q.device)
    valid = slots < cur_len
    if window is not None:
        valid = (valid & (slots >= cur_len - window)) | (cur_len > Skv)
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgc,bckd->bkgd", p.to(COMPUTE_DTYPE).float(),
                     v_cache.to(COMPUTE_DTYPE).float())
    return o.reshape(B, 1, Hp, hd).to(COMPUTE_DTYPE)


def attn_output(p, o: torch.Tensor,
                layout: HeadLayout | None = None) -> torch.Tensor:
    """o (B, S, Hp, hd) -> (B, S, D) bf16, plus the output bias where
    there is one.  Where ``wo`` holds a model rank's share of
    ``layout``'s query heads, the partial products are summed over the
    model ranks (Megatron's g) before the bias."""
    B, S = o.shape[:2]
    wo = p["wo"]
    y = (o.reshape(B, S, -1).to(COMPUTE_DTYPE)
         @ wo.reshape(-1, wo.shape[-1]).to(COMPUTE_DTYPE))
    if layout is not None and _split(wo.shape[0], layout.q_padded,
                                     C.model_size(), "attn.wo"):
        y = C.reduce_from_model(y)
    if "bo" in p:
        y = y + p["bo"].to(COMPUTE_DTYPE)
    return y


def write_prompt_kv(cache, i: int, k: torch.Tensor, v: torch.Tensor):
    """Layer i's prompt k/v (B, S, Kp, hd) into ``cache["k"]/["v"]`` (L,
    B, Skv, Kp, hd): slots [0, S) when they fit, else (a sliding or local
    window's ring, shorter than the prompt) the last Skv positions,
    position p in slot p % Skv, the slot a decode step writes p to."""
    S, Skv = k.shape[1], cache["k"].shape[2]
    if S <= Skv:
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    else:
        shift = (S - Skv) % Skv
        cache["k"][i] = torch.roll(k[:, S - Skv:], shift, dims=1)
        cache["v"][i] = torch.roll(v[:, S - Skv:], shift, dims=1)


def check_ring(name: str, pos: int, Skv: int, window: int) -> None:
    """Raise ``ValueError`` where a decode step at ``pos`` would overwrite
    a position its ``window`` still reads: a full ring of ``Skv`` slots
    shorter than the window."""
    if pos >= Skv and Skv < window:
        raise ValueError(
            f"{name}: the KV ring of {Skv} slots is shorter than the "
            f"{window}-token window and full: position {pos} would "
            f"overwrite position {pos - Skv}, which the window still "
            f"reads; prefill with a cache_len of at least "
            f"{min(pos + 1, window)}")


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


def swiglu(p, x: torch.Tensor, d_ff: int | None = None) -> torch.Tensor:
    """The SwiGLU MLP, bf16 products, SiLU in float32.  Where the params
    hold a model rank's share of the ``d_ff`` hidden units, x enters
    through Megatron's f and the down projection's partial sums leave
    through its g."""
    cd = COMPUTE_DTYPE
    split = d_ff is not None and _split(p["w_down"].shape[0], d_ff,
                                        C.model_size(), "mlp.w_down")
    if split:
        x = C.copy_to_model(x)
    xc = x.to(cd)
    g = xc @ p["w_gate"].to(cd)
    u = xc @ p["w_up"].to(cd)
    h = torch.nn.functional.silu(g.float()).to(cd) * u
    y = h @ p["w_down"].to(cd)
    return C.reduce_from_model(y) if split else y


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
                  bias: bool = True, device=None,
                  dtype: torch.dtype = COMPUTE_DTYPE):
    """The reference's GELU MLP: w_in (D, F), w_out (F, D) and, with
    ``bias``, zero b_in (F,) and b_out (D,), all in ``dtype``."""
    p = {"w_in": _normal(gen, (d_model, d_ff), d_model ** -0.5,
                         device).to(dtype),
         "w_out": _normal(gen, (d_ff, d_model), d_ff ** -0.5,
                          device).to(dtype)}
    if bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def gelu_mlp(p, x: torch.Tensor, d_ff: int | None = None) -> torch.Tensor:
    """x @ w_in (+ b_in), GELU (tanh approximation) in float32, @ w_out (+
    b_out): bf16 products and bias adds, as the reference's.  Where the
    params hold a model rank's share of the ``d_ff`` hidden units (and of
    ``b_in``), x enters through Megatron's f, the output projection's
    partial sums leave through its g, and ``b_out`` is added once, after
    the sum."""
    cd = COMPUTE_DTYPE
    split = d_ff is not None and _split(p["w_out"].shape[0], d_ff,
                                        C.model_size(), "mlp.w_out")
    if split:
        x = C.copy_to_model(x)
    h = x.to(cd) @ p["w_in"].to(cd)
    if "b_in" in p:
        h = h + p["b_in"].to(cd)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(cd)
    y = h @ p["w_out"].to(cd)
    if split:
        y = C.reduce_from_model(y)
    if "b_out" in p:
        y = y + p["b_out"].to(cd)
    return y


# ---------------------------------------------------------------------------
# Depthwise causal convolution (the SSM and hybrid blocks)
# ---------------------------------------------------------------------------

def run_block(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): recomputed in the backward pass
    instead of keeping its activations.  The recomputation runs under the
    ambient mesh of the forward (``collectives.ambient``; a card's
    backward runs on another thread); where collectives run it recomputes
    the whole block, so every forward collective runs again in the
    backward, a count the collective account can state."""
    if not remat:
        return fn(*args)
    ambient = C.ambient()

    def again(*a):
        with ambient():
            return fn(*a)

    whole = (torch.utils.checkpoint.set_checkpoint_early_stop(False)
             if C.active() else contextlib.nullcontext())
    with whole:
        return torch.utils.checkpoint.checkpoint(again, *args,
                                                 use_reentrant=False)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along S: x (B, S, C), w (K, C) stored
    newest-first (tap j multiplies x_{t-j}), b (C,); float32 sums of the
    K taps in the reference's order, cast back to x's dtype."""
    K, S = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + pad[:, i:i + S].float() * w[K - 1 - i].float()
    return (out + b.float()).to(x.dtype)


def conv_tail(x: torch.Tensor, K: int) -> torch.Tensor:
    """The last K - 1 rows of x (B, S, C), left-padded with zeros when S is
    shorter: the convolution state a decode step continues from (the
    causal convolution pads with zeros, so the padding is exact)."""
    tail = x[:, -(K - 1):]
    return torch.nn.functional.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


# ---------------------------------------------------------------------------
# Mixture of experts (GShard-style capacity routing, per batch row)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, *, pad_to: int = 0, device=None,
             dtype: torch.dtype = COMPUTE_DTYPE):
    """The reference's MoE params: the router (D, E) float32 whatever
    ``dtype`` (it routes in float32, and rounding its weights would move
    near-tied choices), the expert matrices (E, D, F) / (E, F, D) in
    ``dtype``.  ``pad_to`` > ``num_experts`` adds dead experts, which
    ``moe_apply`` masks out of the router."""
    std_in, std_out = d_model ** -0.5, d_ff ** -0.5
    E = max(num_experts, pad_to)
    return {
        "router": _normal(gen, (d_model, E), std_in, device),
        "w_gate": _normal(gen, (E, d_model, d_ff), std_in, device).to(dtype),
        "w_up": _normal(gen, (E, d_model, d_ff), std_in, device).to(dtype),
        "w_down": _normal(gen, (E, d_ff, d_model), std_out,
                          device).to(dtype),
    }


#: per thread, the list ``moe_apply`` adds its (kept, routed) slot counts
#: to while :func:`count_moe_slots` is open there
_SLOT_COUNTS = threading.local()


@contextlib.contextmanager
def count_moe_slots():
    """Collect each ``moe_apply`` call's (kept, routed) (token, k) slot
    counts in this thread into the yielded list while the block runs
    (each call then waits for the device to read its count)."""
    prev = getattr(_SLOT_COUNTS, "counts", None)
    _SLOT_COUNTS.counts = counts = []
    try:
        yield counts
    finally:
        _SLOT_COUNTS.counts = prev


def moe_capacity(S: int, top_k: int, num_experts: int,
                 capacity_factor: float, min_capacity: int = 4) -> int:
    """Slots an expert takes a batch row: ``max(min_capacity, ceil(S k /
    E cf))`` capped at S k."""
    cap = max(min_capacity,
              int(math.ceil(S * top_k / num_experts * capacity_factor)))
    return min(cap, S * top_k)


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, min_capacity: int = 4,
              num_real_experts: int = 0, ep: bool = False,
              d_ff: int | None = None):
    """Token-choice top-k MoE with a per-row capacity, the reference's
    arithmetic -> (y (B, S, D) in x's dtype, the Switch aux loss).

    The router runs in float32; its top k probabilities (ties to the lower
    expert, as ``lax.top_k``) are renormalised into gates.  Each (token,
    k) pair takes the next slot of its expert in token-major order; pairs
    past the row's capacity are dropped (they read the zero row S).  The
    expert products are bf16 with SiLU in float32.  The combine: with
    ``ep=False`` each kept pair reads its slot's output back, weighted by
    its gate; with ``ep=True`` (the reference's expert-parallel layout)
    each slot's output, times its gate in float32, is scatter-added into
    its token's row.  The aux loss is E times the sum over experts of the
    share of first choices and the mean probability (means over the
    global batch inside ``collectives.batch_split``).

    On a model rank holding an n-th of the experts (``ep=True``) or of
    the ``d_ff`` hidden units (``ep=False``) the routing runs whole on
    every rank, x and the gates enter the experts through Megatron's f,
    each rank runs its share and the partial (B, S, D) float32 outputs
    are summed over the ranks (g).  The router stays float32 and
    replicated.
    """
    B, S, D = x.shape
    E = p["router"].shape[-1]
    E_real = num_real_experts or E
    cap = moe_capacity(S, top_k, E_real, capacity_factor, min_capacity)
    n = C.model_size()
    if ep:
        split = _split(p["w_gate"].shape[0], E, n, "moe.w_gate")
    else:
        split = d_ff is not None and _split(p["w_down"].shape[1], d_ff, n,
                                            "moe.w_down")
    dev = x.device

    logits = x.float() @ p["router"].float()                  # (B, S, E)
    if E_real < E:
        logits = logits.masked_fill(torch.arange(E, device=dev) >= E_real,
                                    -1e30)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :top_k], expert_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    xin = x
    if split:
        gate_vals, xin = C.copy_to_model(gate_vals), C.copy_to_model(x)

    # position of each (token, k) within its expert, token-major order: a
    # running count over the pairs, one row an expert (a scan along the
    # last dimension; along the pairs of a (B, T, E) one-hot it is slow)
    T = S * top_k
    flat_e = expert_idx.reshape(B, T)
    mine = flat_e[:, None, :] == torch.arange(E, device=dev)[:, None]
    pos_in_e = torch.gather(mine.long().cumsum(dim=-1), 1,
                            flat_e[:, None, :])[:, 0] - 1     # (B, T)
    keep = pos_in_e < cap
    counts = getattr(_SLOT_COUNTS, "counts", None)
    if counts is not None:
        counts.append((int(keep.sum()), keep.numel()))

    # the token each (expert, slot) reads; S (the zero row) where empty.
    # Dropped pairs write to a spare column ``cap``, cut off after.
    tok_idx = (torch.arange(T, device=dev) // top_k).expand(B, T)
    cols = torch.where(keep, pos_in_e, cap)
    slot_at = flat_e * (cap + 1) + cols
    slot_tok = torch.full((B, E * (cap + 1)), S, dtype=torch.long,
                          device=dev)
    slot_tok.scatter_(1, slot_at, tok_idx)
    slot_tok = slot_tok.view(B, E, cap + 1)[..., :cap]

    xpad = torch.cat([xin, xin.new_zeros(B, 1, D)], dim=1)   # (B, S+1, D)
    if ep:
        # this rank's experts; the gates scattered into their slots
        El = p["w_gate"].shape[0]
        e0 = C.model_rank() * El if split else 0
        slot_gate = torch.zeros((B, E * (cap + 1)), dtype=torch.float32,
                                device=dev).scatter(
            1, slot_at, gate_vals.reshape(B, T).float())
        slot_gate = slot_gate.view(B, E, cap + 1)[:, e0:e0 + El, :cap]
        tok = slot_tok[:, e0:e0 + El].reshape(B, El * cap)
        ye = _expert_ffn(p, _gather_slots(xpad, tok.view(B, El, cap)))
        yw = (ye.float() * slot_gate[..., None]).reshape(B, El * cap, D)
        y = torch.zeros((B, S + 1, D), dtype=torch.float32,
                        device=dev).scatter_add(
            1, tok[..., None].expand(-1, -1, D), yw)[:, :S]
    else:
        ye = _expert_ffn(p, _gather_slots(xpad, slot_tok))   # (B,E,cap,D)
        # each (token, k) reads its slot if kept
        flat_slot = flat_e * cap + torch.where(keep, pos_in_e, 0)
        yk = _gather_slots(ye.reshape(B, E * cap, D),
                           flat_slot.reshape(B, S, top_k))   # (B,S,k,D)
        w = (gate_vals * keep.reshape(B, S, top_k)).float()
        y = torch.einsum("bskd,bsk->bsd", yk.float(), w)
    if split:
        y = C.reduce_from_model(y)

    # load-balance auxiliary loss (Switch-style) over the first choices
    frac_tokens = torch.nn.functional.one_hot(
        expert_idx[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    if C.reduces_over_data():
        frac_tokens, frac_probs = C.mean_over_data(
            torch.stack([frac_tokens, frac_probs]))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y.to(x.dtype), aux


#: the most bytes of float32 SiLU input one expert product holds: larger
#: slot sets (mixtral at capacity factor 8 over 5000 tokens: 4.6 GB for
#: its 8 experts) run a few experts at a time, each product the same
_EXPERT_CHUNK_BYTES = 1 << 30


def _expert_ffn(p, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its slots: xe (B, E, cap, D) bf16 -> (B, E,
    cap, D) bf16, products in bf16 and SiLU in float32, over as few
    chunks of experts as keep each chunk's float32 intermediate under
    ``_EXPERT_CHUNK_BYTES``."""
    B, E, cap, _ = xe.shape
    per = max(1, _EXPERT_CHUNK_BYTES // max(1, 4 * B * cap
                                            * p["w_gate"].shape[-1]))
    cd = COMPUTE_DTYPE
    out = []
    for e in range(0, E, per):
        x = xe[:, e:e + per]
        g = torch.einsum("becd,edf->becf", x, p["w_gate"][e:e + per].to(cd))
        u = torch.einsum("becd,edf->becf", x, p["w_up"][e:e + per].to(cd))
        h = torch.nn.functional.silu(g.float()).to(cd) * u
        out.append(torch.einsum("becf,efd->becd", h,
                                p["w_down"][e:e + per].to(cd)))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _gather_slots(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (B, N, D), idx (B, ...) -> (B, ..., D) bf16, row b's entries
    of src[b]."""
    B, N, D = src.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, D)
    out = torch.gather(src.to(COMPUTE_DTYPE), 1, flat)
    return out.reshape(*idx.shape, D)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab_padded: int, d_model: int, *,
                   device=None, dtype: torch.dtype = COMPUTE_DTYPE):
    return {"table": _normal(gen, (vocab_padded, d_model), 0.01,
                             device).to(dtype)}


def token_ids(tokens, device) -> torch.Tensor:
    """Token ids (a tensor or an array) as a long tensor on ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens))
    return tokens.to(device=device, dtype=torch.long)


def embed(p, tokens: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """The rows of ``p["table"]`` the tokens pick, bf16.  Where the table
    holds a model rank's share of the ``vocab`` rows, the lookup is
    masked to this rank's rows (zeros elsewhere) and summed over the
    model ranks (Megatron's g)."""
    table = p["table"]
    if vocab is None or not _split(table.shape[0], vocab, C.model_size(),
                                   "embed.table"):
        return table[tokens].to(COMPUTE_DTYPE)
    rows = table.shape[0]
    local = tokens - C.model_rank() * rows
    mine = (local >= 0) & (local < rows)
    x = table[torch.where(mine, local, 0)].to(COMPUTE_DTYPE)
    return C.reduce_from_model(torch.where(mine[..., None], x, 0.0))


def init_unembed(gen: torch.Generator, d_model: int, vocab_padded: int, *,
                 device=None, dtype: torch.dtype = COMPUTE_DTYPE):
    return {"w": _normal(gen, (d_model, vocab_padded), d_model ** -0.5,
                         device).to(dtype)}


def unembed(p, x: torch.Tensor, cols: int | None = None) -> torch.Tensor:
    """x (..., D) -> logits (..., Vp) bf16; with ``cols``, only the first
    ``cols`` vocabulary columns (the same dot products)."""
    w = p["w"] if cols is None else p["w"][:, :cols]
    return x.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)


def tied_logits(table: torch.Tensor, x: torch.Tensor,
                vocab: int | None = None) -> torch.Tensor:
    """x (..., D) against the embedding table (Vp, D): the tied
    unembedding, bf16.  Where the table holds a model rank's share of the
    ``vocab`` rows, x enters through Megatron's f and the logits are
    gathered over the model ranks."""
    if vocab is None or not _split(table.shape[0], vocab, C.model_size(),
                                   "embed.table"):
        return x.to(COMPUTE_DTYPE) @ table.to(COMPUTE_DTYPE).t()
    x = C.copy_to_model(x.to(COMPUTE_DTYPE))
    return C.gather_from_model(x @ table.to(COMPUTE_DTYPE).t())


def lm_logits(params, cfg, x: torch.Tensor, cols: int | None = None, *,
              vocab: int | None = None) -> torch.Tensor:
    """The final RMS norm (``params["final_norm"]``) and unembedding of x:
    through the embedding table when ``cfg.tie_embeddings``, else
    ``params["unembed"]``; ``cols`` unembeds only the first that many
    vocabulary columns.  Where the table holds a model rank's share of
    the ``vocab`` columns, x enters through Megatron's f and the logits
    are gathered over the model ranks: every rank returns all of them."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    w = (params["embed"]["table"].t() if cfg.tie_embeddings
         else params["unembed"]["w"])
    if vocab is None or not _split(w.shape[1], vocab, C.model_size(),
                                   "unembedding"):
        if cfg.tie_embeddings:
            table = params["embed"]["table"]
            return tied_logits(table if cols is None else table[:cols], x)
        return unembed(params["unembed"], x, cols)
    if cols is not None:
        raise NotImplementedError(
            "the first vocabulary columns of a vocab-split unembedding "
            "(the DWN head's features) on several model ranks")
    x = C.copy_to_model(x.to(COMPUTE_DTYPE))
    return C.gather_from_model(x @ w.to(COMPUTE_DTYPE))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       vocab_real: int, z_loss: float = 1e-4
                       ) -> torch.Tensor:
    """Next-token cross-entropy with padded-vocab masking and z-loss, the
    reference's expression.

    logits: (B, S, Vp) (bf16 ok); labels: (B, S) integer (-1 = ignore).
    Returns the float32 mean over the labelled positions of
    ``logsumexp - picked`` plus ``z_loss`` times the mean of
    ``logsumexp ** 2``: :func:`cross_entropy_sums`' sum over its count.
    """
    total, count = cross_entropy_sums(logits, labels, vocab_real=vocab_real,
                                      z_loss=z_loss)
    return total / torch.clamp(count, min=1.0)


def batch_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                        vocab_real: int) -> torch.Tensor:
    """:func:`cross_entropy_loss` over the global batch: inside
    ``collectives.batch_split`` the sums and counts of every data rank's
    rows together (elsewhere the batch's own)."""
    with torch.profiler.record_function("lm.cross_entropy"):
        total, count = cross_entropy_sums(logits, labels,
                                          vocab_real=vocab_real)
        if C.reduces_over_data():
            total, count = C.sum_over_data(torch.stack([total, count]))
        return total / torch.clamp(count, min=1.0)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor, *,
                       vocab_real: int, z_loss: float = 1e-4):
    """(the sum over the labelled positions of ``logsumexp - picked`` plus
    ``z_loss`` times that of ``logsumexp ** 2``, the count of labelled
    positions), float32 scalars: the parts a mean over a batch whose rows
    several ranks hold adds up."""
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
    return nll.sum() + z_loss * z.sum(), valid.sum()


# ---------------------------------------------------------------------------
# The reference's param trees, carried across
# ---------------------------------------------------------------------------

def tree_from_numpy(node, *, f32, dtype: torch.dtype, device,
                    index: int | None = None):
    """A nested dict of numpy arrays (the reference's params) as tensors on
    ``device``: a leaf whose name is in ``f32`` float32, every other in
    ``dtype``; with ``index``, entry ``index`` of each leaf's leading
    (stacked-layers) axis."""
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out[k] = tree_from_numpy(v, f32=f32, dtype=dtype, device=device,
                                     index=index)
            continue
        t = torch.from_numpy(np.array(v if index is None else v[index],
                                      np.float32))
        out[k] = (t if k in f32 else t.to(dtype)).to(device)
    return out


def layers_from_numpy(stacked, n: int, **kw) -> list:
    """A stacked layer tree (leading axis ``n``) as a list of ``n``
    per-layer trees (:func:`tree_from_numpy`'s arguments)."""
    return [tree_from_numpy(stacked, index=i, **kw) for i in range(n)]



# ---------------------------------------------------------------------------
# logical axes of the params (sharding.partition), keyed like the params
# ---------------------------------------------------------------------------

def axes_rms_norm():
    return {"scale": logical("norm", name="norm.scale")}


def axes_layer_norm():
    return {"scale": logical("norm", name="ln.scale"),
            "bias": logical("norm", name="ln.bias")}


def axes_attention(*, qkv_bias: bool = False, qk_norm: bool = False,
                   out_bias: bool = False):
    a = {
        "wq": logical("embed", "q_heads", "head_dim", name="attn.wq"),
        "wk": logical("embed", None, "head_dim", name="attn.wk"),
        "wv": logical("embed", None, "head_dim", name="attn.wv"),
        "wo": logical("q_heads", "head_dim", "embed", name="attn.wo"),
    }
    if qkv_bias:
        a["bq"] = logical("q_heads", "head_dim", name="attn.bq")
        a["bk"] = logical(None, "head_dim", name="attn.bk")
        a["bv"] = logical(None, "head_dim", name="attn.bv")
    if out_bias:
        a["bo"] = logical(None, name="attn.bo")
    if qk_norm:
        a["q_norm"] = logical("norm", name="attn.q_norm")
        a["k_norm"] = logical("norm", name="attn.k_norm")
    return a


def axes_swiglu():
    return {"w_gate": logical("embed", "ff", name="mlp.w_gate"),
            "w_up": logical("embed", "ff", name="mlp.w_up"),
            "w_down": logical("ff", "embed", name="mlp.w_down")}


def axes_gelu_mlp(*, bias: bool = True):
    a = {"w_in": logical("embed", "ff", name="mlp.w_in"),
         "w_out": logical("ff", "embed", name="mlp.w_out")}
    if bias:
        a["b_in"] = logical("ff", name="mlp.b_in")
        a["b_out"] = logical(None, name="mlp.b_out")
    return a


def axes_moe(*, ep: bool = False):
    """ep=False: TP over the expert hidden dim; ep=True: experts over
    "model", the hidden dim whole on each shard."""
    e_ax = "experts_ep" if ep else "experts"
    f_ax = None if ep else "ff"
    return {
        "router": logical("embed", None, name="moe.router"),
        "w_gate": logical(e_ax, "embed", f_ax, name="moe.w_gate"),
        "w_up": logical(e_ax, "embed", f_ax, name="moe.w_up"),
        "w_down": logical(e_ax, f_ax, "embed", name="moe.w_down"),
    }


def axes_embedding():
    return {"table": logical("vocab", "embed", name="embed.table")}


def axes_unembed():
    return {"w": logical("embed", "vocab", name="unembed.w")}


def axes_layers(fn, n: int) -> list:
    """The axes of ``n`` layers, a list as the params keep them (the
    reference stacks them on a leading "layers" axis, never sharded)."""
    return [fn() for _ in range(n)]


__all__ = [
    "COMPUTE_DTYPE", "HeadLayout", "PARAM_DTYPE", "apply_rope",
    "attention_causal_tri", "attention_chunked", "attention_decode",
    "attn_output", "axes_attention", "axes_embedding", "axes_gelu_mlp",
    "batch_cross_entropy",
    "axes_layer_norm", "axes_layers", "axes_moe", "axes_rms_norm",
    "axes_swiglu", "axes_unembed", "causal_conv", "check_ring", "conv_tail",
    "count_moe_slots", "cross_entropy_loss", "cross_entropy_sums", "embed", "gelu_mlp",
    "init_attention", "init_embedding", "init_generator", "init_gelu_mlp", "init_layer_norm",
    "init_moe", "init_swiglu", "init_unembed", "layer_norm",
    "layers_from_numpy", "lm_logits", "local_kv", "local_layout",
    "heads_split", "make_head_layout", "model_kv", "model_part",
    "moe_apply",
    "moe_capacity", "pad_kv", "proj", "qkv_project", "rms_norm",
    "rms_norm_model",
    "rope_frequencies", "run_block", "swiglu", "tied_logits", "token_ids",
    "tree_from_numpy", "unembed", "write_prompt_kv",
]
