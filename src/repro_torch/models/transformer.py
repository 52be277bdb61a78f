"""Decoder-only transformer LM, dense family: the port's counterpart of the
reference's ``repro.models.transformer``.

* A Python loop over the layers (the reference scans over stacked
  params); params are a dict whose ``"layers"`` entry is a list of
  per-layer dicts.
* Prefill attention goes through the flash-attention kernel
  (``kernels/flash_attn``) when ``cfg.attn_impl == "pallas"`` and through
  the plain chunked attention for ``"masked"``; decode attends to the KV
  cache in plain PyTorch.
* One card: there is no tensor parallelism, so the head layout is the
  reference's at tp = 1.

Interface:
    init_params(cfg, *, seed, device)        -> params
    params_from_numpy(tree, cfg, *, device)  -> params (reference init)
    forward(params, cfg, batch, *, collect_kv) -> (logits, aux, kv)
    prefill(params, cfg, batch, *, cache_len)  -> (last logits, cache)
    init_cache(cfg, batch_size, cache_len, *, device) -> cache (zeros)
    decode_step(params, cfg, cache, tokens)  -> (logits, cache)
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attn import ops as flash
from . import layers as L

ATTN_IMPLS = ("masked", "pallas")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's transformer does
    not run yet (ROADMAP Queue 1 item 8)."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if cfg.attn_impl not in ATTN_IMPLS:
        missing.append(f"attn_impl {cfg.attn_impl!r}")
    if cfg.swa_window is not None:
        missing.append("sliding-window attention")
    if cfg.qkv_bias:
        missing.append("qkv bias")
    if cfg.tie_embeddings:
        missing.append("tied embeddings")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            f"Queue 1 item 8); the port runs dense models with attn_impl "
            f"in {ATTN_IMPLS}")


def _layout(cfg: ArchConfig) -> L.HeadLayout:
    return L.make_head_layout(cfg.num_heads, cfg.num_kv_heads, 1)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, *, seed: int = 0, device=None):
    """Random params from a ``torch.Generator`` on ``device`` with the
    reference's stds and dead-slot zeroing (matrix weights bf16, norm
    scales float32).  ``torch`` and ``jax.random`` give different numbers
    from one seed: to compute what the reference computes, carry its
    params across with :func:`params_from_numpy`."""
    check_supported(cfg)
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = _layout(cfg)
    D, V = cfg.d_model, cfg.vocab_padded(1)
    ones = lambda: {"scale": torch.ones(D, device=dev)}  # noqa: E731
    layers = [{"ln1": ones(),
               "attn": L.init_attention(gen, D, layout, cfg.head_dim_,
                                        qk_norm=cfg.qk_norm, device=dev),
               "ln2": ones(),
               "mlp": L.init_swiglu(gen, D, cfg.d_ff, device=dev)}
              for _ in range(cfg.num_layers)]
    return {"embed": L.init_embedding(gen, V, D, device=dev),
            "layers": layers,
            "final_norm": ones(),
            "unembed": L.init_unembed(gen, D, V, device=dev)}


def params_from_numpy(tree, cfg: ArchConfig, *, device=None):
    """The reference's dense param tree (``init_params(key, cfg, tp=1)``
    as numpy arrays, layers stacked on a leading axis) as the port's
    params: matrix weights to bf16, norm scales float32, the layer axis
    split into a list."""
    check_supported(cfg)
    dev = torch.device("cpu" if device is None else device)

    def leaf(a, name):
        t = torch.from_numpy(np.array(a, np.float32))
        if not (name == "scale" or name.endswith("_norm")):
            t = t.to(L.COMPUTE_DTYPE)
        return t.to(dev)

    def convert(node, i=None):
        return {k: (convert(v, i) if isinstance(v, dict)
                    else leaf(v if i is None else v[i], k))
                for k, v in node.items()}

    stacked = tree["layers"]
    return {"embed": convert(tree["embed"]),
            "layers": [convert(stacked, i) for i in range(cfg.num_layers)],
            "final_norm": convert(tree["final_norm"]),
            "unembed": convert(tree["unembed"])}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _block_apply(lp, cfg: ArchConfig, layout: L.HeadLayout,
                 x: torch.Tensor, positions: torch.Tensor):
    """One layer over the whole sequence -> (x, k, v)."""
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], h, positions=positions,
                            rope_theta=cfg.rope_theta or None,
                            qk_norm_eps=cfg.norm_eps)
    if cfg.attn_impl == "pallas":
        # K10 keeps its scores in float32 whatever attn_scores_bf16 says,
        # as the reference's pallas path does
        o = flash.attend(q, k, v, causal=True,
                         block=min(cfg.attn_chunk, q.shape[1]))
    else:
        sdt = torch.bfloat16 if cfg.attn_scores_bf16 else torch.float32
        o = L.attention_chunked(q, k, v, layout, causal=True,
                                kv_chunk=cfg.attn_chunk, scores_dtype=sdt)
    x = x + L.attn_output(lp["attn"], o)
    h = L.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h), k, v


def _tokens(batch, device) -> torch.Tensor:
    toks = batch["tokens"]
    if not isinstance(toks, torch.Tensor):
        toks = torch.from_numpy(np.asarray(toks))
    return toks.to(device=device, dtype=torch.long)


def _layers(params, cfg: ArchConfig, tokens: torch.Tensor, cache=None):
    """Embed and run every layer -> the last hidden state (B, S, D); each
    layer's k/v is written into ``cache`` (positions [0, S)) when given,
    else collected and returned stacked."""
    check_supported(cfg)
    layout = _layout(cfg)
    x = L.embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for i, lp in enumerate(params["layers"]):
        x, k, v = _block_apply(lp, cfg, layout, x, positions)
        if cache is not None:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        else:
            ks.append(k)
            vs.append(v)
    return x, ks, vs


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return L.unembed(params["unembed"], x)


def forward(params, cfg: ArchConfig, batch, *, collect_kv: bool = False):
    """Full-sequence forward -> (logits (B, S, Vp) bf16, aux 0.0, (k, v)
    stacked over layers (L, B, S, Kp, hd) or None)."""
    tokens = _tokens(batch, params["embed"]["table"].device)
    x, ks, vs = _layers(params, cfg, tokens)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return _logits(params, cfg, x), 0.0, kvs


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode against a KV cache
# ---------------------------------------------------------------------------

def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """KV-cache length for ``seq_len`` tokens (the dense family keeps
    every position)."""
    check_supported(cfg)
    return seq_len


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, *,
               device=None):
    layout = _layout(cfg)
    shape = (cfg.num_layers, batch_size, cache_len_for(cfg, cache_len),
             layout.kv_padded, cfg.head_dim_)
    dev = torch.device("cpu" if device is None else device)
    return {"k": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=dev),
            "pos": 0}                           # tokens written so far


def prefill(params, cfg: ArchConfig, batch, *, cache_len: int | None = None):
    """Process the whole prompt -> (last-token logits (B, Vp), cache).

    The cache has ``cache_len`` positions (default: the prompt's; fewer
    than the prompt's raise ``ValueError``) and holds the prompt's k/v.
    Only the last position is unembedded: the reference computes every
    position's logits and keeps the last."""
    dev = params["embed"]["table"].device
    tokens = _tokens(batch, dev)
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{S}-token prompt")
    cache = init_cache(cfg, B, cache_len, device=dev)
    x, _, _ = _layers(params, cfg, tokens, cache)
    cache["pos"] = S
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ArchConfig, cache, tokens):
    """One decode step: tokens (B, 1) against the cache -> (logits (B, Vp),
    cache).  The cache is updated in place (the reference returns a new
    one) and returned."""
    check_supported(cfg)
    layout = _layout(cfg)
    dev = params["embed"]["table"].device
    x = L.embed(params["embed"], _tokens({"tokens": tokens}, dev))
    pos = int(cache["pos"])
    Skv = cache["k"].shape[2]
    slot = min(pos, Skv - 1)
    cur = min(pos + 1, Skv)
    positions = torch.full((x.shape[0], 1), pos, device=dev)
    for i, lp in enumerate(params["layers"]):
        hn = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], hn, positions=positions,
                                rope_theta=cfg.rope_theta or None,
                                qk_norm_eps=cfg.norm_eps)
        cache["k"][i, :, slot] = k[:, 0]
        cache["v"][i, :, slot] = v[:, 0]
        o = L.attention_decode(q, cache["k"][i], cache["v"][i], layout,
                               cur_len=cur)
        x = x + L.attn_output(lp["attn"], o)
        hn = L.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps)
        x = x + L.swiglu(lp["mlp"], hn)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x)[:, 0], cache


__all__ = [
    "ATTN_IMPLS", "cache_len_for", "check_supported", "decode_step",
    "forward", "init_cache", "init_params", "params_from_numpy", "prefill",
]
