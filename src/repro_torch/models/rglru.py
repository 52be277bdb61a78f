"""RecurrentGemma (Griffin), the hybrid LM of RG-LRU recurrent blocks and
local attention: the port's counterpart of the reference's
``repro.models.rglru``.

* Layers repeat [recurrent, recurrent, attention] superblocks (26 layers:
  8 superblocks and 2 trailing recurrent layers).  Attention is MQA with
  a local window (``cfg.local_window``) and RoPE; every block has a
  SwiGLU MLP.
* The RG-LRU, per channel: r = sigmoid(W_a x + b_a), i = sigmoid(W_x x +
  b_x), a = exp(8 r log sigmoid(Lambda)), h_t = a_t h_{t-1} + sqrt(1 -
  a_t^2) (i_t x_t).  Over a sequence it runs as a doubling scan: ceil(log2
  S) elementwise passes, each combining every position with the one 2^k
  before it (the reference's ``lax.associative_scan`` sums in another
  order; both are plain array code, no Pallas kernel).  Decode is the
  one-step recurrence.
* The local attention's KV cache is a ring of min(cache_len, window)
  slots, position p in slot p % slots after prefill as after each decode
  step.  The reference keeps the prompt's last window in order, so after
  a prompt that is no multiple of the window its first decode step
  overwrites a position still inside the window (ROADMAP fault 11).  A
  full ring shorter than the window raises ``ValueError``.
* ``tp`` (every function's keyword, 1 by default) lays the attention
  heads, the KV ring and the vocabulary out as the reference's do at that
  tensor-parallel degree (the MQA's one KV head repeated, query heads
  padded).  On one device that is the reference's arithmetic at tp.  On
  the ranks of a ``DeviceMesh`` (``api.make_*(mesh=)``) each function
  runs this rank's shards: where the model ranks divide the RG-LRU width
  (the partitioner's "lru" split), the recurrent block is column-parallel
  into its channels (``w_gate``, ``w_in``, the depthwise convolution, the
  scan), the gates' products read the convolution's output gathered over
  "model" (``collectives.gather_for_model``: ``wa``/``wx`` take the whole
  width in and give this rank's channels out) and ``w_out`` is
  row-parallel; where they do not, every rank runs the whole block.  The
  attention and the MLPs split as the transformer's; the cache holds
  this rank's RG-LRU channels and KV heads.
* Params: ``{"embed", "super": {"rec1", "rec2", "attn"}: lists over the
  superblocks, "tail": list, "final_norm"}``; matrices in ``dtype``, the
  leaves the reference reads in float32 (norm scales, the convolution,
  the gates' W_a, W_x and biases, Lambda) float32 in either form.

Interface (the transformer's):
    init_params(cfg, *, tp, seed, device, dtype) -> params
    params_from_numpy(tree, cfg, *, device, dtype) -> params
    forward(params, cfg, batch, *, tp) -> (logits (B, S, Vp), None)
    loss_fn(params, cfg, batch, *, tp) -> scalar loss
    init_cache(cfg, batch_size, cache_len, *, tp, device) -> cache
    prefill(params, cfg, batch, *, tp, cache_len) -> (last logits, cache)
    decode_step(params, cfg, cache, tokens, *, tp) -> (logits, cache)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding import collectives as C
from ..sharding.partition import logical
from . import layers as L

LRU_C = 8.0
CONV_K = 4
#: leaves kept float32 in either param form
F32_LEAVES = ("scale", "conv_w", "conv_b", "wa", "ba", "wx", "bx", "lam")


def _layout(cfg: ArchConfig, tp: int) -> L.HeadLayout:
    return L.make_head_layout(cfg.num_heads, cfg.num_kv_heads, tp)


def _lru_split(cfg: ArchConfig) -> bool:
    """Whether this model rank runs its share of the RG-LRU channels: the
    model ranks (of the ambient mesh) divide the width, so the
    partitioner splits "lru"."""
    n = C.model_size()
    return n > 1 and cfg.lru_width % n == 0


#: the attention's leaves that the model axis leaves whole but whose
#: gradient a model rank computes only in part
MODEL_PARTIAL = {"attn": ("wk", "wv")}


def partial_grad(path, cfg: ArchConfig | None = None, tp: int = 1) -> bool:
    """Whether the leaf at ``path`` is one of :data:`MODEL_PARTIAL`
    (``models.parallel.reduce_grads``): the recurrent block's leaves are
    split over "model" or run whole on every rank, never partial."""
    return len(path) >= 2 and path[-1] in MODEL_PARTIAL.get(path[-2], ())


def block_pattern(num_layers: int) -> list[str]:
    """['rec', 'rec', 'attn', ...] for the given depth."""
    return [("attn" if i % 3 == 2 else "rec") for i in range(num_layers)]


def _num_super(cfg: ArchConfig) -> tuple[int, int]:
    """(full superblocks, trailing recurrent layers)."""
    ns = cfg.num_layers // 3
    return ns, cfg.num_layers - 3 * ns


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _init_rec_layer(gen, cfg: ArchConfig, dev, dtype):
    D, W = cfg.d_model, cfg.lru_width

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln1": {"scale": torch.ones(D, device=dev)},
        "w_gate": normal((D, W), D ** -0.5).to(dtype),
        "w_in": normal((D, W), D ** -0.5).to(dtype),
        "conv_w": normal((CONV_K, W), CONV_K ** -0.5),
        "conv_b": torch.zeros(W, **f32),
        "wa": normal((W, W), W ** -0.5 * 0.1),
        "ba": torch.zeros(W, **f32),
        "wx": normal((W, W), W ** -0.5 * 0.1),
        "bx": torch.zeros(W, **f32),
        "lam": torch.linspace(2.2, 6.9, W, **f32),
        "w_out": normal((W, D), W ** -0.5).to(dtype),
        "ln2": {"scale": torch.ones(D, device=dev)},
        "mlp": L.init_swiglu(gen, D, cfg.d_ff, device=dev, dtype=dtype),
    }


def _init_attn_layer(gen, cfg: ArchConfig, layout, dev, dtype):
    D = cfg.d_model
    return {
        "ln1": {"scale": torch.ones(D, device=dev)},
        "attn": L.init_attention(gen, D, layout, cfg.head_dim_,
                                 device=dev, dtype=dtype),
        "ln2": {"scale": torch.ones(D, device=dev)},
        "mlp": L.init_swiglu(gen, D, cfg.d_ff, device=dev, dtype=dtype),
    }


def init_params(cfg: ArchConfig, *, tp: int = 1, seed: int = 0, device=None,
                dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Random params laid out at ``tp`` from a ``torch.Generator`` on
    ``device`` with the reference's stds and Lambda grid (see the module's
    docstring for the dtypes)."""
    dev = torch.device("cpu" if device is None else device)
    gen = L.init_generator(dev, seed)
    ns, nt = _num_super(cfg)
    V = cfg.vocab_padded(tp)
    layout = _layout(cfg, tp)
    rec = lambda: _init_rec_layer(gen, cfg, dev, dtype)  # noqa: E731
    params = {
        "embed": L.init_embedding(gen, V, cfg.d_model, device=dev,
                                  dtype=dtype),
        "super": {"rec1": [rec() for _ in range(ns)],
                  "rec2": [rec() for _ in range(ns)],
                  "attn": [_init_attn_layer(gen, cfg, layout, dev, dtype)
                           for _ in range(ns)]},
        "final_norm": {"scale": torch.ones(cfg.d_model, device=dev)},
    }
    if nt:
        params["tail"] = [rec() for _ in range(nt)]
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_unembed(gen, cfg.d_model, V, device=dev,
                                           dtype=dtype)
    return params


def _axes_rec_layer():
    return {
        "ln1": L.axes_rms_norm(),
        "w_gate": logical("embed", "lru", name="rec.w_gate"),
        "w_in": logical("embed", "lru", name="rec.w_in"),
        "conv_w": logical(None, "lru", name="rec.conv_w"),
        "conv_b": logical("lru", name="rec.conv_b"),
        "wa": logical(None, "lru", name="rec.wa"),
        "ba": logical("lru", name="rec.ba"),
        "wx": logical(None, "lru", name="rec.wx"),
        "bx": logical("lru", name="rec.bx"),
        "lam": logical("lru", name="rec.lam"),
        "w_out": logical("lru", "embed", name="rec.w_out"),
        "ln2": L.axes_rms_norm(),
        "mlp": L.axes_swiglu(),
    }


def _axes_attn_layer():
    return {"ln1": L.axes_rms_norm(), "attn": L.axes_attention(),
            "ln2": L.axes_rms_norm(), "mlp": L.axes_swiglu()}


def param_axes(cfg: ArchConfig):
    """Logical axes of :func:`init_params`'s tree (``sharding``)."""
    ns, nt = _num_super(cfg)
    a = {"embed": L.axes_embedding(),
         "super": {"rec1": L.axes_layers(_axes_rec_layer, ns),
                   "rec2": L.axes_layers(_axes_rec_layer, ns),
                   "attn": L.axes_layers(_axes_attn_layer, ns)},
         "final_norm": L.axes_rms_norm()}
    if nt:
        a["tail"] = L.axes_layers(_axes_rec_layer, nt)
    if not cfg.tie_embeddings:
        a["unembed"] = L.axes_unembed()
    return a


def params_from_numpy(tree, cfg: ArchConfig, *, device=None,
                      dtype: torch.dtype = L.COMPUTE_DTYPE):
    """The reference's tree (``init_params(key, cfg, tp)`` as numpy,
    superblocks and tail stacked) as the port's params."""
    ns, nt = _num_super(cfg)
    kw = dict(f32=F32_LEAVES, dtype=dtype,
              device=torch.device("cpu" if device is None else device))
    out = {}
    for k, v in tree.items():
        if k == "super":
            out[k] = {n: L.layers_from_numpy(t, ns, **kw)
                      for n, t in v.items()}
        elif k == "tail":
            out[k] = L.layers_from_numpy(v, nt, **kw)
        else:
            out[k] = L.tree_from_numpy(v, **kw)
    return out


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_scan(xw: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                lam: torch.Tensor, h0: torch.Tensor | None = None):
    """xw, r, i (B, S, W) -> (h (B, S, W) in xw's dtype, the last h (B, W)
    float32), from ``h0`` (B, W) or zeros.

    h_t = a_t h_{t-1} + b_t as a doubling scan over (a, b): at pass k each
    position t >= 2^k takes (a_{t-2^k} a_t, a_t b_{t-2^k} + b_t), so after
    ceil(log2 S) passes b_t is h_t."""
    log_a = LRU_C * r.float() * F.logsigmoid(lam.float())
    a = torch.exp(log_a)
    b = (torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
         * (i.float() * xw.float()))
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0.float()
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b.to(xw.dtype), b[:, -1]


def _rec_block(lp, cfg: ArchConfig, x: torch.Tensor, *, h0=None,
               conv0=None):
    """Griffin's recurrent block and its MLP over x (B, S, D), continuing
    from the RG-LRU state ``h0`` (B, W) and the convolution's previous
    inputs ``conv0`` (B, K-1, W) where given -> (x, the last RG-LRU state
    (B, W) float32, the convolution's inputs xw (B, S, W) bf16)."""
    cd = L.COMPUTE_DTYPE
    W, split = cfg.lru_width, _lru_split(cfg)

    def part(name, dim):
        return L.model_part(lp[name], W, dim, split, f"rec.{name}")

    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
    if split:
        h = C.copy_to_model(h)
    gate = F.gelu(L.proj(h, part("w_gate", 1)).float(),
                  approximate="tanh").to(cd)
    xw = L.proj(h, part("w_in", 1))
    conv_w, conv_b = part("conv_w", 1), part("conv_b", 0)
    if conv0 is not None:
        full = torch.cat([conv0.to(cd), xw], dim=1)
        conv = L.causal_conv(full, conv_w, conv_b)
        conv = conv[:, conv0.shape[1]:]
    else:
        conv = L.causal_conv(xw, conv_w, conv_b)
    # the gates read every channel of the convolution's output, gathered
    # in float32 so that the backward sums the ranks' float32 gradients
    # and rounds them to bf16 once, as one device does
    cf = conv.float()
    if split:
        cf = C.gather_for_model(cf, -1)
    r = torch.sigmoid(cf @ part("wa", 1).float() + part("ba", 0).float())
    i = torch.sigmoid(cf @ part("wx", 1).float() + part("bx", 0).float())
    y, h_last = _rglru_scan(conv, r, i, part("lam", 0), h0=h0)
    out = L.proj(y * gate, part("w_out", 0))
    x = x + (C.reduce_from_model(out) if split else out)
    x = x + L.swiglu(lp["mlp"], L.rms_norm(x, lp["ln2"]["scale"],
                                           cfg.norm_eps), cfg.d_ff)
    return x, h_last, xw


def _attn_mlp(lp, cfg: ArchConfig, layout, x: torch.Tensor,
              o: torch.Tensor):
    """The attention block's output projection, residual and MLP."""
    x = x + L.attn_output(lp["attn"], o, layout)
    return x + L.swiglu(lp["mlp"], L.rms_norm(x, lp["ln2"]["scale"],
                                              cfg.norm_eps), cfg.d_ff)


def _attn_block(lp, cfg: ArchConfig, layout, x: torch.Tensor,
                positions: torch.Tensor):
    """Local (windowed, causal) attention and MLP over x -> (x, k, v)."""
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], h, layout, positions=positions,
                            rope_theta=cfg.rope_theta or None)
    with torch.profiler.record_function("lm.attention"):
        o = L.attention_chunked(q, k, v,
                                L.local_layout(layout, C.model_size()),
                                causal=True, window=cfg.local_window,
                                kv_chunk=cfg.attn_chunk)
    return _attn_mlp(lp, cfg, layout, x, o), k, v


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _run(params, cfg: ArchConfig, tokens: torch.Tensor, cache=None, *,
         tp: int = 1):
    """Embed and run every block -> the last hidden state; with ``cache``
    each block's RG-LRU state, convolution tail and k/v are written
    there."""
    layout = _layout(cfg, tp)
    x = L.embed(params["embed"], tokens, cfg.vocab_padded(tp))
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    remat = cfg.remat and x.requires_grad

    def rec(lp, x, lru, conv, i):
        x, h_last, xw = L.run_block(remat, _rec_block, lp, cfg, x)
        if cache is not None:
            cache[lru][i] = h_last
            cache[conv][i] = L.conv_tail(xw, CONV_K)
        return x

    sup = params["super"]
    for i in range(len(sup["attn"])):
        x = rec(sup["rec1"][i], x, "lru1", "conv1", i)
        x = rec(sup["rec2"][i], x, "lru2", "conv2", i)
        x, k, v = L.run_block(remat, _attn_block, sup["attn"][i], cfg,
                              layout, x, positions)
        if cache is not None:
            L.write_prompt_kv(cache, i, k, v)
    for i, lp in enumerate(params.get("tail", [])):
        x = rec(lp, x, "lru_t", "conv_t", i)
    return x


def forward(params, cfg: ArchConfig, batch, *, tp: int = 1):
    """Full-sequence forward -> (logits (B, S, Vp) bf16, None)."""
    tokens = L.token_ids(batch["tokens"], params["embed"]["table"].device)
    return L.lm_logits(params, cfg, _run(params, cfg, tokens, tp=tp),
                       vocab=cfg.vocab_padded(tp)), None


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
    """The reference's cache: RG-LRU states (float32) and convolution
    tails (bf16) of the superblocks' two recurrent layers and of the tail
    (one zero entry when there is no tail), and the attention layers' KV
    ring of min(cache_len, local_window) slots, its heads laid out at
    ``tp``; on a model rank its RG-LRU channels and KV heads."""
    layout = L.local_layout(_layout(cfg, tp), C.model_size())
    ns, nt = _num_super(cfg)
    W, B = cfg.lru_width, batch_size
    if _lru_split(cfg):
        W //= C.model_size()
    Skv = min(cache_len, cfg.local_window)
    dev = torch.device("cpu" if device is None else device)
    cd = L.COMPUTE_DTYPE
    lru = lambda n: torch.zeros((n, B, W), device=dev)  # noqa: E731
    conv = lambda n: torch.zeros((n, B, CONV_K - 1, W), dtype=cd,  # noqa: E731
                                 device=dev)
    kv = (ns, B, Skv, layout.kv_padded, cfg.head_dim_)
    return {"lru1": lru(ns), "conv1": conv(ns), "lru2": lru(ns),
            "conv2": conv(ns),
            "k": torch.zeros(kv, dtype=cd, device=dev),
            "v": torch.zeros(kv, dtype=cd, device=dev),
            "lru_t": lru(max(nt, 1)), "conv_t": conv(max(nt, 1)),
            "pos": 0}


def cache_axes(cfg: ArchConfig, *, seq_shard: bool = False):
    kv = logical("layers", "batch", None, "kv_heads", "head_dim",
                 name="cache.kv")
    lru = logical("layers", "batch", "lru", name="cache.lru")
    conv = logical("layers", "batch", None, "lru", name="cache.conv")
    return {"lru1": lru, "conv1": conv, "lru2": lru, "conv2": conv,
            "k": kv, "v": kv, "lru_t": lru, "conv_t": conv,
            "pos": logical(name="cache.pos")}


def prefill(params, cfg: ArchConfig, batch, *, tp: int = 1,
            cache_len: int | None = None):
    """The whole prompt -> (last-token logits (B, Vp), cache); the KV ring
    holds the prompt's last min(cache_len, window) positions, position p
    in slot p % slots.  ``cache_len`` defaults to the prompt's; shorter
    raises ``ValueError``."""
    dev = params["embed"]["table"].device
    tokens = L.token_ids(batch["tokens"], dev)
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{S}-token prompt")
    cache = init_cache(cfg, B, cache_len, tp=tp, device=dev)
    x = _run(params, cfg, tokens, cache, tp=tp)
    cache["pos"] = S
    return (L.lm_logits(params, cfg, x[:, -1:],
                        vocab=cfg.vocab_padded(tp))[:, 0], cache)


def _rec_step(lp, cfg: ArchConfig, x, cache, lru: str, conv: str, i: int):
    """One token through a recurrent block, its state and convolution
    tail updated in the cache."""
    x, h_last, xw = _rec_block(lp, cfg, x, h0=cache[lru][i],
                               conv0=cache[conv][i])
    cache[lru][i] = h_last
    cache[conv][i] = torch.cat([cache[conv][i][:, 1:], xw], dim=1)
    return x


def decode_step(params, cfg: ArchConfig, cache, tokens, *, tp: int = 1):
    """One token (B, 1) -> (logits (B, Vp), cache), the cache updated in
    place: the recurrences advance one step and the attention layers write
    slot pos % Skv of their ring."""
    layout = _layout(cfg, tp)
    local = L.local_layout(layout, C.model_size())
    dev = params["embed"]["table"].device
    x = L.embed(params["embed"], L.token_ids(tokens, dev),
                cfg.vocab_padded(tp))
    pos = int(cache["pos"])
    Skv = cache["k"].shape[2]
    L.check_ring(cfg.name, pos, Skv, cfg.local_window)
    positions = torch.full((x.shape[0], 1), pos, device=dev)
    sup = params["super"]
    for i, lp in enumerate(sup["attn"]):
        x = _rec_step(sup["rec1"][i], cfg, x, cache, "lru1", "conv1", i)
        x = _rec_step(sup["rec2"][i], cfg, x, cache, "lru2", "conv2", i)
        hn = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], hn, layout, positions=positions,
                                rope_theta=cfg.rope_theta or None)
        cache["k"][i, :, pos % Skv] = k[:, 0]
        cache["v"][i, :, pos % Skv] = v[:, 0]
        o = L.attention_decode(q, cache["k"][i], cache["v"][i],
                               local, cur_len=pos + 1,
                               window=cfg.local_window)
        x = _attn_mlp(lp, cfg, layout, x, o)
    for i, lp in enumerate(params.get("tail", [])):
        x = _rec_step(lp, cfg, x, cache, "lru_t", "conv_t", i)
    cache["pos"] = pos + 1
    return (L.lm_logits(params, cfg, x, vocab=cfg.vocab_padded(tp))[:, 0],
            cache)


__all__ = ["F32_LEAVES", "MODEL_PARTIAL", "block_pattern", "cache_axes",
           "decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "param_axes", "params_from_numpy", "partial_grad", "prefill"]
