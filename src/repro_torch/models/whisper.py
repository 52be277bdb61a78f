"""Whisper-large-v3's backbone, the encoder-decoder LM: the port's
counterpart of the reference's ``repro.models.whisper``.

* The audio frontend is a stub, as in the reference: a batch carries
  precomputed frame embeddings ``frames`` (B, enc_frames, D).  Sinusoidal
  positions are added to them, a non-causal MHA encoder runs over them,
  and a causal decoder with cross-attention to the encoder's states runs
  over the text tokens (sinusoidal positions too).
* LayerNorms with bias, GELU MLPs with biases, attention with q/k/v and
  output biases; the unembedding is tied to the token embedding.
* Serving: prefill runs the encoder once and the decoder over the prompt;
  the cache holds the decoder's self-attention K/V and each decoder
  layer's cross-attention K/V of the encoder states (``xk``/``xv``),
  computed once.  A decode step adds the current token's sinusoidal
  position (clamped to the cache's length, as the reference's).
* Params: ``{"embed", "enc_layers": list, "enc_ln", "dec_layers": list,
  "dec_ln"}``; matrices and their biases in ``dtype``, norm scales and
  biases float32.
* ``tp`` (every function's keyword, 1 by default) lays the heads, the
  caches and the vocabulary out as the reference's do at that degree (the
  MHA's query heads padded with dead heads, K/V with zero heads, the
  cached cross K/V too).  On one device that is the reference's
  arithmetic at tp.  On the ranks of a ``DeviceMesh``
  (``api.make_*(mesh=)``) each function runs this rank's shards: its
  query heads (self and cross attention alike) and the KV heads they
  read, its share of the MLPs' hidden units and of the vocabulary, with
  Megatron's f and g (``layers``); the encoder states enter the cross
  K/V projections through one f, and the caches (self and cross) hold
  this rank's KV heads.

Interface (the transformer's, plus the encoder's parts):
    init_params(cfg, *, tp, seed, device, dtype) -> params
    params_from_numpy(tree, cfg, *, device, dtype) -> params
    encode(params, cfg, frames, *, tp) -> encoder states (B, F, D)
    cross_kv(params, cfg, enc_states, *, tp) -> ([k], [v]) a decoder layer
    decode_train(params, cfg, tokens, enc_states, *, tp) -> logits
    forward(params, cfg, batch, *, tp) -> (logits, 0.0)
    loss_fn(params, cfg, batch, *, tp) -> scalar loss
    init_cache(cfg, batch_size, cache_len, *, tp, device) -> cache
    prefill(params, cfg, batch, *, tp, cache_len) -> (last logits, cache)
    decode_step(params, cfg, cache, tokens, *, tp) -> (logits, cache)
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..optim.adam import leaves
from ..sharding import collectives as C
from ..sharding.partition import logical
from . import layers as L

#: leaves kept float32 in either param form: the LayerNorms'
F32_LEAVES = ("scale", "bias")
#: the attentions' leaves that the model axis leaves whole (the true KV
#: heads) but whose gradient a model rank computes only in part
MODEL_PARTIAL = {name: ("wk", "wv", "bk", "bv")
                 for name in ("attn", "self_attn", "cross_attn")}


def partial_grad(path, cfg: ArchConfig | None = None, tp: int = 1) -> bool:
    """Whether the leaf at ``path`` is one of :data:`MODEL_PARTIAL`
    (``models.parallel.reduce_grads``)."""
    return len(path) >= 2 and path[-1] in MODEL_PARTIAL.get(path[-2], ())


def _layout(cfg: ArchConfig, tp: int) -> L.HeadLayout:
    return L.make_head_layout(cfg.num_heads, cfg.num_kv_heads, tp)


def sinusoid_positions(length: int, dim: int, start: int = 0) -> np.ndarray:
    """(length, dim) float32 sinusoidal positions of ``start + p``: sines
    of pos / 10000^(2i/dim) over the first half, cosines over the second
    (the reference's table; ``start`` gives its rows from there)."""
    pos = np.arange(start, start + length)[:, None].astype(np.float32)
    i = np.arange(dim // 2)[None, :].astype(np.float32)
    angle = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(angle), np.cos(angle)],
                          -1).astype(np.float32)


def _positions(length, dim, device, start=0) -> torch.Tensor:
    return torch.from_numpy(sinusoid_positions(length, dim, start)).to(
        device=device, dtype=L.COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, *, tp: int = 1, seed: int = 0, device=None,
                dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Random params laid out at ``tp`` from a ``torch.Generator`` on
    ``device`` with the reference's stds (see the module's docstring for
    the dtypes)."""
    dev = torch.device("cpu" if device is None else device)
    gen = L.init_generator(dev, seed)
    layout = _layout(cfg, tp)
    D = cfg.d_model
    ln = lambda: L.init_layer_norm(D, device=dev)  # noqa: E731
    mlp = lambda: L.init_gelu_mlp(gen, D, cfg.d_ff, device=dev,  # noqa: E731
                                  dtype=dtype)
    attn = lambda: L.init_attention(  # noqa: E731
        gen, D, layout, cfg.head_dim_, qkv_bias=True, out_bias=True,
        device=dev, dtype=dtype)
    return {
        "embed": L.init_embedding(gen, cfg.vocab_padded(tp), D, device=dev,
                                  dtype=dtype),
        "enc_layers": [{"ln1": ln(), "attn": attn(),
                        "ln2": ln(), "mlp": mlp()}
                       for _ in range(cfg.enc_layers)],
        "enc_ln": ln(),
        "dec_layers": [{"ln1": ln(),
                        "self_attn": attn(),
                        "ln_x": ln(),
                        "cross_attn": attn(),
                        "ln2": ln(), "mlp": mlp()}
                       for _ in range(cfg.num_layers)],
        "dec_ln": ln(),
    }


def _axes_enc_layer():
    return {"ln1": L.axes_layer_norm(),
            "attn": L.axes_attention(qkv_bias=True, out_bias=True),
            "ln2": L.axes_layer_norm(), "mlp": L.axes_gelu_mlp()}


def _axes_dec_layer():
    return {"ln1": L.axes_layer_norm(),
            "self_attn": L.axes_attention(qkv_bias=True, out_bias=True),
            "ln_x": L.axes_layer_norm(),
            "cross_attn": L.axes_attention(qkv_bias=True, out_bias=True),
            "ln2": L.axes_layer_norm(), "mlp": L.axes_gelu_mlp()}


def param_axes(cfg: ArchConfig):
    """Logical axes of :func:`init_params`'s tree (``sharding``)."""
    return {"embed": L.axes_embedding(),
            "enc_layers": L.axes_layers(_axes_enc_layer, cfg.enc_layers),
            "enc_ln": L.axes_layer_norm(),
            "dec_layers": L.axes_layers(_axes_dec_layer, cfg.num_layers),
            "dec_ln": L.axes_layer_norm()}


def params_from_numpy(tree, cfg: ArchConfig, *, device=None,
                      dtype: torch.dtype = L.COMPUTE_DTYPE):
    """The reference's tree (``init_params(key, cfg, tp)`` as numpy, the
    encoder's and decoder's layers stacked) as the port's params."""
    kw = dict(f32=F32_LEAVES, dtype=dtype,
              device=torch.device("cpu" if device is None else device))
    depth = {"enc_layers": cfg.enc_layers, "dec_layers": cfg.num_layers}
    return {k: (L.layers_from_numpy(v, depth[k], **kw) if k in depth
                else L.tree_from_numpy(v, **kw))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def _ln(p, x, cfg):
    return L.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _local(layout: L.HeadLayout) -> L.HeadLayout:
    """This model rank's share of ``layout`` (all of it without a mesh)."""
    return L.local_layout(layout, C.model_size())


def _enc_block(lp, cfg: ArchConfig, layout, h: torch.Tensor):
    q, k, v = L.qkv_project(lp["attn"], _ln(lp["ln1"], h, cfg), layout,
                            positions=None, rope_theta=None)
    with torch.profiler.record_function("lm.attention"):
        o = L.attention_chunked(q, k, v, _local(layout), causal=False,
                                kv_chunk=cfg.attn_chunk)
    h = h + L.attn_output(lp["attn"], o, layout)
    return h + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], h, cfg), cfg.d_ff)


def encode(params, cfg: ArchConfig, frames, *, tp: int = 1) -> torch.Tensor:
    """frames (B, F, D) stub embeddings -> encoder states (B, F, D) bf16."""
    layout = _layout(cfg, tp)
    dev = params["embed"]["table"].device
    frames = torch.as_tensor(frames).to(dev)
    B, Fr, D = frames.shape
    h = frames.to(L.COMPUTE_DTYPE) + _positions(Fr, D, dev)
    # every layer whose params take a gradient, the first too (its input,
    # the frames, takes none)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params["enc_layers"]))
    for lp in params["enc_layers"]:
        h = L.run_block(remat, _enc_block, lp, cfg, layout, h)
    return _ln(params["enc_ln"], h, cfg)


def cross_kv(params, cfg: ArchConfig, enc_states: torch.Tensor, *,
             tp: int = 1):
    """Each decoder layer's cross-attention K and V of the encoder states,
    laid out at ``tp`` (``layers.pad_kv``): two lists of (B, F, Kp, hd)
    bf16.  On a model rank holding a share of the query heads, the KV
    heads those read (``layers.model_kv``), the encoder states entering
    every layer's projections through one Megatron f."""
    layout = _layout(cfg, tp)
    cd = L.COMPUTE_DTYPE
    layers = params["dec_layers"]
    split = bool(layers) and L.heads_split(layers[0]["cross_attn"], layout)
    if split:
        enc_states = C.copy_to_model(enc_states)
    ks, vs = [], []
    for lp in layers:
        ca = lp["cross_attn"]
        k = L.pad_kv(L.proj(enc_states, ca["wk"]) + ca["bk"].to(cd), layout)
        v = L.pad_kv(L.proj(enc_states, ca["wv"]) + ca["bv"].to(cd), layout)
        if split:
            k, v = L.model_kv(k, layout), L.model_kv(v, layout)
        ks.append(k)
        vs.append(v)
    return ks, vs


def _cross_q(lp, cfg: ArchConfig, layout, x: torch.Tensor) -> torch.Tensor:
    """The cross attention's queries of x: this rank's heads, x entering
    through Megatron's f, where ``wq`` holds a share of them."""
    ca = lp["cross_attn"]
    h = _ln(lp["ln_x"], x, cfg)
    if L.heads_split(ca, layout):
        h = C.copy_to_model(h)
    return L.proj(h, ca["wq"]) + ca["bq"].to(L.COMPUTE_DTYPE)


def _dec_block(lp, cfg: ArchConfig, layout, x, positions, k_enc, v_enc):
    """Causal self-attention, cross-attention to (k_enc, v_enc), GELU MLP
    over x (B, S, D) -> (x, k, v)."""
    q, k, v = L.qkv_project(lp["self_attn"], _ln(lp["ln1"], x, cfg),
                            layout, positions=positions, rope_theta=None)
    local = _local(layout)
    with torch.profiler.record_function("lm.attention"):
        o = L.attention_chunked(q, k, v, local, causal=True,
                                kv_chunk=cfg.attn_chunk)
    x = x + L.attn_output(lp["self_attn"], o, layout)
    with torch.profiler.record_function("lm.attention"):
        ox = L.attention_chunked(_cross_q(lp, cfg, layout, x), k_enc, v_enc,
                                 local, causal=False,
                                 kv_chunk=cfg.attn_chunk)
    x = x + L.attn_output(lp["cross_attn"], ox, layout)
    return (x + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg), cfg.d_ff),
            k, v)


def _decoder(params, cfg: ArchConfig, tokens, enc_states, cache=None, *,
             tp: int = 1):
    """The decoder over ``tokens`` (B, S) -> its last hidden state after
    ``dec_ln``; with ``cache``, each layer's k/v goes to slots [0, S) and
    its cross K/V to ``xk``/``xv``."""
    dev = enc_states.device
    B, S = tokens.shape
    x = (L.embed(params["embed"], tokens, cfg.vocab_padded(tp))
         + _positions(S, cfg.d_model, dev))
    positions = torch.arange(S, device=dev).expand(B, S)
    layout = _layout(cfg, tp)
    xks, xvs = cross_kv(params, cfg, enc_states, tp=tp)
    for i, lp in enumerate(params["dec_layers"]):
        x, k, v = L.run_block(cfg.remat and x.requires_grad, _dec_block, lp,
                              cfg, layout, x, positions, xks[i], xvs[i])
        if cache is not None:
            L.write_prompt_kv(cache, i, k, v)
            cache["xk"][i], cache["xv"][i] = xks[i], xvs[i]
    return _ln(params["dec_ln"], x, cfg)


def decode_train(params, cfg: ArchConfig, tokens, enc_states, *,
                 tp: int = 1):
    """Teacher-forced decoder logits (B, S, Vp) bf16 of ``tokens`` over
    ``enc_states``."""
    tokens = L.token_ids(tokens, enc_states.device)
    return L.tied_logits(params["embed"]["table"],
                         _decoder(params, cfg, tokens, enc_states, tp=tp),
                         cfg.vocab_padded(tp))


def forward(params, cfg: ArchConfig, batch, *, tp: int = 1):
    """Encoder over ``batch["frames"]``, decoder over ``batch["tokens"]``
    -> (logits (B, S, Vp) bf16, 0.0)."""
    enc = encode(params, cfg, batch["frames"], tp=tp)
    return decode_train(params, cfg, batch["tokens"], enc, tp=tp), 0.0


def loss_fn(params, cfg: ArchConfig, batch, *, tp: int = 1) -> torch.Tensor:
    """Cross-entropy of positions [0, S-1) against labels [1, S) (inside
    ``collectives.batch_split`` the mean over the data ranks' rows
    together)."""
    logits, _ = forward(params, cfg, batch, tp=tp)
    labels = L.token_ids(batch["labels"], logits.device)
    return L.batch_cross_entropy(logits[:, :-1], labels[:, 1:],
                                 vocab_real=cfg.vocab_size)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, *,
               tp: int = 1, device=None):
    """Self-attention K/V (L, B, cache_len, Kp, hd) and cross K/V (L, B,
    enc_frames, Kp, hd), bf16 zeros, Kp the layout's at ``tp``; on a
    model rank its KV heads (``layers.local_layout``)."""
    layout = _local(_layout(cfg, tp))
    dev = torch.device("cpu" if device is None else device)

    def zeros(n):
        return torch.zeros((cfg.num_layers, batch_size, n, layout.kv_padded,
                            cfg.head_dim_), dtype=L.COMPUTE_DTYPE, device=dev)
    return {"k": zeros(cache_len), "v": zeros(cache_len),
            "xk": zeros(cfg.enc_frames), "xv": zeros(cfg.enc_frames),
            "pos": 0}


def cache_axes(cfg: ArchConfig, *, seq_shard: bool = False):
    kv = logical("layers", "batch", None, "kv_heads", "head_dim",
                 name="cache.kv")
    return {"k": kv, "v": kv, "xk": kv, "xv": kv,
            "pos": logical(name="cache.pos")}


def prefill(params, cfg: ArchConfig, batch, *, tp: int = 1,
            cache_len: int | None = None):
    """Encoder and the decoder over the prompt -> (last-token logits (B,
    Vp), cache).  ``cache_len`` defaults to the prompt's; shorter raises
    ``ValueError``."""
    dev = params["embed"]["table"].device
    tokens = L.token_ids(batch["tokens"], dev)
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{S}-token prompt")
    enc = encode(params, cfg, batch["frames"], tp=tp)
    cache = init_cache(cfg, B, cache_len, tp=tp, device=dev)
    x = _decoder(params, cfg, tokens, enc, cache, tp=tp)
    cache["pos"] = S
    return (L.tied_logits(params["embed"]["table"], x[:, -1],
                          cfg.vocab_padded(tp)), cache)


def decode_step(params, cfg: ArchConfig, cache, tokens, *, tp: int = 1):
    """One decoder token (B, 1) -> (logits (B, Vp), cache), the cache
    updated in place: slot min(pos, Skv - 1) of the self-attention cache,
    the token's position min(pos, Skv), as the reference's."""
    layout = _layout(cfg, tp)
    local = _local(layout)
    dev = params["embed"]["table"].device
    pos = int(cache["pos"])
    Skv = cache["k"].shape[2]
    x = (L.embed(params["embed"], L.token_ids(tokens, dev),
                 cfg.vocab_padded(tp))
         + _positions(1, cfg.d_model, dev, start=min(pos, Skv)))
    slot, cur = min(pos, Skv - 1), min(pos + 1, Skv)
    for i, lp in enumerate(params["dec_layers"]):
        q, k, v = L.qkv_project(lp["self_attn"], _ln(lp["ln1"], x, cfg),
                                layout, positions=None, rope_theta=None)
        cache["k"][i, :, slot] = k[:, 0]
        cache["v"][i, :, slot] = v[:, 0]
        o = L.attention_decode(q, cache["k"][i], cache["v"][i], local,
                               cur_len=cur)
        x = x + L.attn_output(lp["self_attn"], o, layout)
        ox = L.attention_decode(_cross_q(lp, cfg, layout, x),
                                cache["xk"][i], cache["xv"][i], local,
                                cur_len=cache["xk"].shape[2])
        x = x + L.attn_output(lp["cross_attn"], ox, layout)
        x = x + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg), cfg.d_ff)
    cache["pos"] = pos + 1
    x = _ln(params["dec_ln"], x, cfg)
    return (L.tied_logits(params["embed"]["table"], x,
                          cfg.vocab_padded(tp))[:, 0], cache)


__all__ = ["F32_LEAVES", "MODEL_PARTIAL", "cache_axes", "cross_kv",
           "decode_step", "decode_train", "encode", "forward", "init_cache",
           "init_params", "loss_fn", "param_axes", "params_from_numpy",
           "partial_grad", "prefill", "sinusoid_positions"]
