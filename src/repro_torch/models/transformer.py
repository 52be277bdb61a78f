"""Decoder-only transformer LM, dense, MoE and VLM families: the port's
counterpart of the reference's ``repro.models.transformer``.

* A Python loop over the layers (the reference scans over stacked
  params); params are a dict whose ``"layers"`` entry is a list of
  per-layer dicts.
* Prefill attention goes through the flash-attention kernel
  (``kernels/flash_attn``) when ``cfg.attn_impl == "pallas"`` and no
  sliding window is set, through the block-triangular recursion for
  ``"tri"`` without a window, and through the plain chunked attention
  otherwise (with the window's mask); decode attends to the KV cache in
  plain PyTorch.
* Options, as the reference's: q/k/v biases (``qkv_bias``), qk-norm,
  tied embeddings (the unembedding reads the embedding table), a sliding
  window (``swa_window``: the KV cache is a ring of at most the window's
  length, position p in slot p % length) and the capacity-routed MoE
  FFN (``family="moe"``), whose aux loss ``forward`` sums over the
  layers.
* VLM (``family="vlm"``, llava-next): the batch's precomputed patch
  embeddings (B, P, D) are prepended to the token embeddings; the KV
  cache holds P more positions, prefill's position counts them, and
  ``loss_fn`` labels the text positions only.
* ``tp`` (every function's keyword, 1 by default; the reference's is
  16) lays the params and the KV cache out as the reference's do at that
  tensor-parallel degree: query heads padded with dead heads, KV heads
  repeated or zero-padded (``layers.make_head_layout``), the vocabulary
  padded to ``cfg.vocab_padded(tp)`` (the loss masks the padded logits).
  On one device that is the reference's arithmetic at tp.  On the ranks
  of a ``DeviceMesh`` (``models.parallel``, ``api.make_*(mesh=)``) each
  function runs this rank's shards: its query heads and the KV heads they
  read (``layers.local_layout``), its share of the MLP's hidden units, of
  the experts (``moe_ep=True``, padded to a multiple of 16 as the
  reference pads them) or of their hidden units, and of the vocabulary;
  the collectives are ``layers``'.  The KV cache holds this rank's rows
  and KV heads.
* On the ``meta`` device (shapes only: the dry-run) the flash-attention
  path runs the kernel's plain version, which launches nothing.
* Params come in two forms: bf16 matrices for serving and float32
  matrices (``dtype=torch.float32``), the reference's master weights,
  for training.  With ``cfg.remat`` and gradients on, each layer runs
  under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``),
  so a training step keeps one (B, S, D) residual per layer.
* Training runs ``attn_impl="masked"``.  The flash-attention kernel has
  no backward (neither has the reference's Pallas kernel: ``jax.grad``
  through it fails), so a forward under ``"pallas"`` whose inputs need
  gradients raises.

Interface:
    init_params(cfg, *, tp, seed, device, dtype) -> params
    params_from_numpy(tree, cfg, *, device, dtype) -> params (reference init)
    forward(params, cfg, batch, *, tp, collect_kv, vocab_cols)
                                             -> (logits, aux, kv)
    loss_fn(params, cfg, batch, *, tp)       -> scalar loss
    prefill(params, cfg, batch, *, tp, cache_len) -> (last logits, cache)
    init_cache(cfg, batch_size, cache_len, *, tp, device) -> cache (zeros)
    decode_step(params, cfg, cache, tokens, *, tp) -> (logits, cache)
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, round_up
from ..kernels.flash_attn import ops as flash
from ..optim.adam import leaves
from ..sharding import collectives as C
from ..sharding.partition import logical
from . import layers as L

ATTN_IMPLS = ("masked", "pallas", "tri")
#: the leaves kept float32 in either param form: norm scales and the MoE
#: router (it routes in float32)
F32_LEAVES = ("scale", "router", "q_norm", "k_norm")
FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's transformer does
    not run: the families of the other modules (``models.api``) and
    attention implementations it lacks."""
    missing = []
    if cfg.family not in FAMILIES:
        missing.append(f"family {cfg.family!r}")
    if cfg.attn_impl not in ATTN_IMPLS:
        missing.append(f"attn_impl {cfg.attn_impl!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not run by the "
            f"transformer, which runs families {FAMILIES} with attn_impl "
            f"in {ATTN_IMPLS}")


#: the attention's leaves that the model axis leaves whole but whose
#: gradient a model rank computes only in part (from its own query heads
#: and the KV heads they read)
MODEL_PARTIAL = {"attn": ("wk", "wv", "bk", "bv", "q_norm", "k_norm")}


def partial_grad(path, cfg: ArchConfig | None = None, tp: int = 1) -> bool:
    """Whether the leaf at ``path`` (keys from the params' root) is one of
    :data:`MODEL_PARTIAL`, whose gradient ``models.parallel`` sums over
    the model ranks (every family's module has one; ``cfg`` and ``tp``
    matter where the model axis splits a block only at some degrees)."""
    return len(path) >= 2 and path[-1] in MODEL_PARTIAL.get(path[-2], ())


def _layout(cfg: ArchConfig, tp: int) -> L.HeadLayout:
    return L.make_head_layout(cfg.num_heads, cfg.num_kv_heads, tp)


def _local_layout(cfg: ArchConfig, tp: int) -> L.HeadLayout:
    """This model rank's share of the layout at tp (the whole layout
    without a ``DeviceMesh``)."""
    return L.local_layout(_layout(cfg, tp), C.model_size())


def num_experts(cfg: ArchConfig) -> int:
    """The experts the params hold: with ``moe_ep`` padded to a multiple
    of 16 (dead experts the router masks), as the reference pads them so
    that they shard over the model axis."""
    return round_up(cfg.num_experts, 16) if cfg.moe_ep else cfg.num_experts


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, *, tp: int = 1, seed: int = 0, device=None,
                dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Random params laid out at ``tp`` from a ``torch.Generator`` on
    ``device`` with the reference's stds and dead-slot zeroing: matrix
    weights in ``dtype``
    (bf16, the serving form; float32, the training form, whose bf16
    rounding is the serving form of the same seed), norm scales float32.
    ``torch`` and ``jax.random`` give different numbers from one seed: to
    compute what the reference computes, carry its params across with
    :func:`params_from_numpy`."""
    check_supported(cfg)
    dev = torch.device("cpu" if device is None else device)
    gen = L.init_generator(dev, seed)
    layout = _layout(cfg, tp)
    D, V = cfg.d_model, cfg.vocab_padded(tp)
    ones = lambda: {"scale": torch.ones(D, device=dev)}  # noqa: E731
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"ln1": ones(),
              "attn": L.init_attention(gen, D, layout, cfg.head_dim_,
                                       qkv_bias=cfg.qkv_bias,
                                       qk_norm=cfg.qk_norm, device=dev,
                                       dtype=dtype),
              "ln2": ones()}
        if cfg.family == "moe":
            lp["moe"] = L.init_moe(gen, D, cfg.d_ff, cfg.num_experts,
                                   pad_to=num_experts(cfg), device=dev,
                                   dtype=dtype)
        else:
            lp["mlp"] = L.init_swiglu(gen, D, cfg.d_ff, device=dev,
                                      dtype=dtype)
        layers.append(lp)
    params = {"embed": L.init_embedding(gen, V, D, device=dev, dtype=dtype),
              "layers": layers,
              "final_norm": ones()}
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_unembed(gen, D, V, device=dev,
                                           dtype=dtype)
    return params


def _block_axes(cfg: ArchConfig):
    a = {"ln1": L.axes_rms_norm(),
         "attn": L.axes_attention(qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
         "ln2": L.axes_rms_norm()}
    if cfg.family == "moe":
        a["moe"] = L.axes_moe(ep=cfg.moe_ep)
    else:
        a["mlp"] = L.axes_swiglu()
    return a


def param_axes(cfg: ArchConfig):
    """Logical axes of :func:`init_params`'s tree (``sharding``)."""
    a = {"embed": L.axes_embedding(),
         "layers": L.axes_layers(lambda: _block_axes(cfg), cfg.num_layers),
         "final_norm": L.axes_rms_norm()}
    if not cfg.tie_embeddings:
        a["unembed"] = L.axes_unembed()
    return a


def params_from_numpy(tree, cfg: ArchConfig, *, device=None,
                      dtype: torch.dtype = L.COMPUTE_DTYPE):
    """The reference's param tree (``init_params(key, cfg, tp)`` as numpy
    arrays, layers stacked on a leading axis) as the port's params, laid
    out at the reference's tp:
    matrix weights and biases to ``dtype`` (bf16 to serve; float32, the
    reference's own values, to train), norm scales and the MoE router
    float32, the layer axis split into a list."""
    check_supported(cfg)
    kw = dict(f32=F32_LEAVES, dtype=dtype,
              device=torch.device("cpu" if device is None else device))
    return {k: (L.layers_from_numpy(v, cfg.num_layers, **kw)
                if k == "layers" else L.tree_from_numpy(v, **kw))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _ffn(lp, cfg: ArchConfig, h: torch.Tensor):
    """The layer's FFN on h (B, S, D) -> (y, aux): SwiGLU (aux 0.0) or
    the MoE at ``cfg``'s routing."""
    if cfg.family == "moe":
        return L.moe_apply(lp["moe"], h, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           num_real_experts=cfg.num_experts, ep=cfg.moe_ep,
                           d_ff=cfg.d_ff)
    return L.swiglu(lp["mlp"], h, d_ff=cfg.d_ff), 0.0


def _block_apply(lp, cfg: ArchConfig, layout: L.HeadLayout,
                 x: torch.Tensor, positions: torch.Tensor):
    """One layer over the whole sequence -> (x, aux, k, v); ``layout`` is
    the whole model's, k and v hold this rank's KV heads."""
    local = L.local_layout(layout, C.model_size())
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], h, layout, positions=positions,
                            rope_theta=cfg.rope_theta or None,
                            qk_norm_eps=cfg.norm_eps)
    flash_path = cfg.attn_impl == "pallas" and cfg.swa_window is None
    if flash_path and q.is_meta:
        # shapes only (the dry-run): the kernel's plain version stands in
        # for K10, which nothing launches on the meta device
        flash_path = False
    if flash_path and q.requires_grad:
        raise NotImplementedError(
            f"{cfg.name}: attn_impl='pallas' has no backward (the "
            f"flash-attention kernel is forward only, as the reference's "
            f"Pallas kernel is); train with attn_impl='masked'")
    sdt = torch.bfloat16 if cfg.attn_scores_bf16 else torch.float32
    # the profiler's range: a training step's split reads it
    with torch.profiler.record_function("lm.attention"):
        if flash_path:
            # K10 keeps its scores in float32 whatever attn_scores_bf16
            # says, as the reference's pallas path does
            o = flash.attend(q, k, v, causal=True,
                             block=min(cfg.attn_chunk, q.shape[1]))
        elif cfg.attn_impl == "pallas" and cfg.swa_window is None:
            o = flash.attention_ref(q, k, v, causal=True)
        elif cfg.attn_impl == "tri" and cfg.swa_window is None:
            o = L.attention_causal_tri(q, k, v, local,
                                       kv_chunk=cfg.attn_chunk,
                                       scores_dtype=sdt)
        else:
            o = L.attention_chunked(q, k, v, local, causal=True,
                                    window=cfg.swa_window,
                                    kv_chunk=cfg.attn_chunk,
                                    scores_dtype=sdt)
    x = x + L.attn_output(lp["attn"], o, layout)
    y, aux = _ffn(lp, cfg, L.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps))
    return x + y, aux, k, v


def _patches(cfg: ArchConfig, batch, device) -> torch.Tensor | None:
    """The batch's patch embeddings (B, P, D) on ``device``, or None: only
    the VLM family reads them."""
    if cfg.family != "vlm" or batch.get("patches") is None:
        return None
    return torch.as_tensor(batch["patches"]).to(device)


def _layers(params, cfg: ArchConfig, tokens: torch.Tensor, cache=None, *,
            tp: int = 1, collect_kv: bool = False,
            patches: torch.Tensor | None = None):
    """Embed (``patches`` (B, P, D) before the tokens' embeddings) and run
    every layer -> (the last hidden state (B, P + S, D), the summed aux
    loss, ks, vs); each layer's k/v is written into ``cache`` when given
    (``layers.write_prompt_kv``), and collected and returned with
    ``collect_kv``.  With ``cfg.remat`` and gradients on, each layer is
    recomputed in the backward pass instead of keeping its
    activations."""
    check_supported(cfg)
    layout = _layout(cfg, tp)
    x = L.embed(params["embed"], tokens, cfg.vocab_padded(tp))
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params))
    aux, ks, vs = 0.0, [], []
    for i, lp in enumerate(params["layers"]):
        x, a, k, v = L.run_block(remat, _block_apply, lp, cfg, layout, x,
                                 positions)
        aux = aux + a
        if cache is not None:
            L.write_prompt_kv(cache, i, k, v)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, aux, ks, vs


def forward(params, cfg: ArchConfig, batch, *, tp: int = 1,
            collect_kv: bool = False, vocab_cols: int | None = None):
    """Full-sequence forward -> (logits (B, S, Vp) bf16, aux (the MoE's
    load-balance loss summed over the layers, a float32 scalar; 0.0 for
    the dense family), (k, v) stacked over layers (L, B, S, Kp, hd) or
    None).  A VLM batch's ``patches`` (B, P, D) come first, so S counts
    them.  ``vocab_cols`` unembeds only the first that many vocabulary
    columns (the DWN head's pooled features read 16 of them)."""
    dev = params["embed"]["table"].device
    tokens = L.token_ids(batch["tokens"], dev)
    x, aux, ks, vs = _layers(params, cfg, tokens, tp=tp,
                             collect_kv=collect_kv,
                             patches=_patches(cfg, batch, dev))
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return (L.lm_logits(params, cfg, x, vocab_cols,
                        vocab=cfg.vocab_padded(tp)), aux, kvs)


def loss_fn(params, cfg: ArchConfig, batch, *, tp: int = 1) -> torch.Tensor:
    """Next-token loss of ``batch`` ({"tokens", "labels"}, (B, S) each):
    the cross-entropy of positions [0, S-1) against labels [1, S), plus
    0.01 times the summed aux loss, as the reference adds it.  A VLM
    batch's patch positions carry no label and are dropped.  Inside
    ``collectives.batch_split`` the mean is over the data ranks' rows
    together."""
    logits, aux, _ = forward(params, cfg, batch, tp=tp)
    if cfg.family == "vlm" and batch.get("patches") is not None:
        logits = logits[:, batch["patches"].shape[1]:]
    labels = L.token_ids(batch["labels"], logits.device)
    ce = L.batch_cross_entropy(logits[:, :-1], labels[:, 1:],
                               vocab_real=cfg.vocab_size)
    return ce + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode against a KV cache
# ---------------------------------------------------------------------------

def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """KV-cache length for ``seq_len`` tokens: every position (a VLM's
    ``num_patches`` image positions ahead of the text included), or at
    most the sliding window's."""
    check_supported(cfg)
    if cfg.family == "vlm":
        seq_len = seq_len + cfg.num_patches
    if cfg.swa_window is not None:
        return min(seq_len, cfg.swa_window)
    return seq_len


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, *,
               tp: int = 1, device=None):
    """Zero K/V (L, B, ``cache_len_for(cfg, cache_len)``, kv_padded at
    ``tp``, hd) bf16 and the position 0; on a model rank its KV heads
    (``layers.local_layout``)."""
    layout = _local_layout(cfg, tp)
    shape = (cfg.num_layers, batch_size, cache_len_for(cfg, cache_len),
             layout.kv_padded, cfg.head_dim_)
    dev = torch.device("cpu" if device is None else device)
    return {"k": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=dev),
            "pos": 0}                           # tokens written so far


def cache_axes(cfg: ArchConfig, *, seq_shard: bool = False):
    seq_ax = "kv_seq_sp" if seq_shard else None
    kv = logical("layers", "batch", seq_ax, "kv_heads", "head_dim",
                 name="cache.kv")
    return {"k": kv, "v": kv, "pos": logical(name="cache.pos")}


def prefill(params, cfg: ArchConfig, batch, *, tp: int = 1,
            cache_len: int | None = None):
    """Process the whole prompt -> (last-token logits (B, Vp), cache).

    The cache has ``cache_len_for(cfg, cache_len)`` positions
    (``cache_len`` defaults to the prompt's; shorter than the prompt
    raises ``ValueError``; a VLM's P patch positions are added to it and
    counted in the cache's position) and holds the prompt's k/v; under a
    sliding
    window shorter than the prompt it holds the last window, position p
    in slot p % window (the reference keeps the last window in order, so
    its first decode step overwrites a position still in the window
    whenever the prompt is no multiple of it).  Only the last position is
    unembedded: the reference computes every position's logits and keeps
    the last."""
    dev = params["embed"]["table"].device
    tokens = L.token_ids(batch["tokens"], dev)
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{S}-token prompt")
    cache = init_cache(cfg, B, cache_len, tp=tp, device=dev)
    x, _, _, _ = _layers(params, cfg, tokens, cache, tp=tp,
                         patches=_patches(cfg, batch, dev))
    cache["pos"] = x.shape[1]
    return (L.lm_logits(params, cfg, x[:, -1:],
                        vocab=cfg.vocab_padded(tp))[:, 0], cache)


def decode_step(params, cfg: ArchConfig, cache, tokens, *, tp: int = 1):
    """One decode step: tokens (B, 1) against the cache -> (logits (B, Vp),
    cache).  The cache is updated in place (the reference returns a new
    one) and returned.  Under a sliding window the new position p goes to
    slot p % Skv; a ring shorter than the window that is full raises
    ``ValueError``, since that slot still holds a position the window
    reads."""
    check_supported(cfg)
    layout = _layout(cfg, tp)
    local = L.local_layout(layout, C.model_size())
    dev = params["embed"]["table"].device
    x = L.embed(params["embed"], L.token_ids(tokens, dev),
                cfg.vocab_padded(tp))
    pos = int(cache["pos"])
    Skv = cache["k"].shape[2]
    window = cfg.swa_window
    if window is None:
        slot, cur = min(pos, Skv - 1), min(pos + 1, Skv)
    else:
        L.check_ring(cfg.name, pos, Skv, window)
        slot, cur = pos % Skv, pos + 1
    positions = torch.full((x.shape[0], 1), pos, device=dev)
    for i, lp in enumerate(params["layers"]):
        hn = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], hn, layout, positions=positions,
                                rope_theta=cfg.rope_theta or None,
                                qk_norm_eps=cfg.norm_eps)
        cache["k"][i, :, slot] = k[:, 0]
        cache["v"][i, :, slot] = v[:, 0]
        o = L.attention_decode(q, cache["k"][i], cache["v"][i], local,
                               cur_len=cur, window=window)
        x = x + L.attn_output(lp["attn"], o, layout)
        y, _ = _ffn(lp, cfg, L.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps))
        x = x + y
    cache["pos"] = pos + 1
    return (L.lm_logits(params, cfg, x, vocab=cfg.vocab_padded(tp))[:, 0],
            cache)


__all__ = [
    "ATTN_IMPLS", "F32_LEAVES", "FAMILIES", "MODEL_PARTIAL", "cache_axes",
    "cache_len_for", "check_supported", "decode_step", "forward",
    "init_cache", "init_params", "loss_fn", "num_experts", "param_axes",
    "partial_grad",
    "params_from_numpy", "prefill",
]
