"""Mamba-2 (SSD, state-space duality), the attention-free LM: the port's
counterpart of the reference's ``repro.models.mamba2``.

* Prefill and training run the chunked SSD of Dao & Gu (arXiv:2405.21060)
  in plain PyTorch, as the reference runs it in plain jnp (no Pallas
  kernel): within a chunk of ``cfg.ssm_chunk`` positions the outputs are
  matrix products (C B^T ⊙ decay mask) (dt·X); across chunks a loop
  carries the (B, H, P, N) float32 state.  A sequence that is no multiple
  of the chunk is padded with dt = 0 (decay 1, no input).
* Products take bf16 operands and accumulate in float32 (the operands
  are cast to float32, which keeps each product of two bf16 values
  exact), as the reference's ``preferred_element_type``.  With one group
  (``ssm_ngroups``), C B^T is computed once a group and scaled per head.
* Decode is the SSM recurrence h = a·h + (dt·x) B^T, y = C·h + D·x, with
  the depthwise convolution's last ``ssm_conv - 1`` inputs kept in the
  cache.  After a prompt shorter than that, the kept inputs are padded
  with zeros in front (exact: the causal convolution pads with zeros);
  the reference keeps the short tail and its first decode step raises
  (ROADMAP fault 12).
* ``tp`` (every function's keyword, 1 by default) pads the vocabulary
  to ``cfg.vocab_padded(tp)``, as the reference's; the SSM has no heads
  to pad, so it changes nothing else on one device.
* On the ranks of a ``DeviceMesh`` (``api.make_*(mesh=)``) where the
  model ranks divide the SSM heads (the partitioner's "ssm_heads"
  split), each rank runs its heads: ``w_z``, ``w_x`` and ``w_dt`` are
  column-parallel (Megatron's f on the normed input), the step, decay
  and skip params and the scan are local by head, ``w_bc`` is
  replicated (every rank computes B and C whole), ``out_norm`` normalises
  over the model-split ``d_inner`` (``layers.rms_norm_model``) and
  ``w_out`` is row-parallel (g).  The convolution's params are laid out
  over "conv_dim" = ``d_inner + 2 G N`` channels, whose n-th chunks do
  not line up with the channels a rank convolves (its ``d_inner / n``
  value channels and every B/C channel), so each block gathers them over
  "model" (one all-gather of the (K + 1, conv_dim) taps and bias; the
  backward a reduce-scatter) and takes its channels.  The cache holds
  this rank's heads and those channels, ``d_inner / n + 2 G N`` a rank
  (not the spec's conv_dim / n: ROADMAP, differences by design).  Where
  the ranks do not divide the heads every rank runs the whole block.
* Params: a dict whose ``"layers"`` entry is a list of per-layer dicts;
  the matrices in ``dtype`` (bf16 to serve, float32 to train), every leaf
  the reference reads in float32 (norm scales, the convolution, the step
  and decay parameters, the skip) float32 in either form.

Interface (the transformer's):
    init_params(cfg, *, tp, seed, device, dtype) -> params
    params_from_numpy(tree, cfg, *, device, dtype) -> params
    forward(params, cfg, batch, *, tp) -> (logits (B, S, Vp), h_last a layer)
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

#: leaves kept float32 in either param form
F32_LEAVES = ("scale", "dt_bias", "A_log", "D_skip", "conv_w", "conv_b")


def _dims(cfg: ArchConfig) -> tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim


def _heads_split(cfg: ArchConfig) -> bool:
    """Whether this model rank runs its share of the SSM heads: the model
    ranks (of the ambient mesh) divide them, so the partitioner splits
    "ssm_heads" (and "conv_dim" of ``d_inner``)."""
    n = C.model_size()
    if n == 1 or _dims(cfg)[1] % n:
        return False
    if cfg.ssm_ngroups != 1:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.ssm_ngroups} B/C groups over {n} model "
            f"ranks; the port splits the heads of one group")
    return True


#: a block's leaves that the model axis leaves whole (``w_bc``; the
#: convolution's where the ranks do not divide its channels) but whose
#: gradient a model rank computes only in part, when it runs its heads
MODEL_PARTIAL = ("w_bc", "conv_w", "conv_b")


def partial_grad(path, cfg: ArchConfig | None = None, tp: int = 1) -> bool:
    """Whether the leaf at ``path`` is one of :data:`MODEL_PARTIAL` of a
    model whose ``tp`` ranks each run their share of the heads
    (``models.parallel.reduce_grads``)."""
    return (cfg is not None and tp > 1 and _dims(cfg)[1] % tp == 0
            and path[0] == "layers" and path[-1] in MODEL_PARTIAL)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchConfig, dev, dtype):
    d_inner, H = _dims(cfg)
    D, N, G, K = cfg.d_model, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_conv
    std = D ** -0.5

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln": {"scale": torch.ones(D, device=dev)},
        "w_z": normal((D, d_inner), std).to(dtype),
        "w_x": normal((D, d_inner), std).to(dtype),
        "w_bc": normal((D, 2 * G * N), std).to(dtype),
        "w_dt": normal((D, H), std).to(dtype),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 0.1, H,
                                                        **f32))),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D_skip": torch.ones(H, **f32),
        "conv_w": normal((K, d_inner + 2 * G * N), K ** -0.5),
        "conv_b": torch.zeros(d_inner + 2 * G * N, **f32),
        "out_norm": {"scale": torch.ones(d_inner, device=dev)},
        "w_out": normal((d_inner, D), d_inner ** -0.5).to(dtype),
    }


def init_params(cfg: ArchConfig, *, tp: int = 1, seed: int = 0, device=None,
                dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Random params from a ``torch.Generator`` on ``device`` with the
    reference's stds and its deterministic step, decay and skip
    initialisations, the vocabulary padded at ``tp`` (see the module's
    docstring for the dtypes)."""
    dev = torch.device("cpu" if device is None else device)
    gen = L.init_generator(dev, seed)
    V = cfg.vocab_padded(tp)
    params = {
        "embed": L.init_embedding(gen, V, cfg.d_model, device=dev,
                                  dtype=dtype),
        "layers": [_init_block(gen, cfg, dev, dtype)
                   for _ in range(cfg.num_layers)],
        "final_norm": {"scale": torch.ones(cfg.d_model, device=dev)},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_unembed(gen, cfg.d_model, V, device=dev,
                                           dtype=dtype)
    return params


def _block_axes(cfg: ArchConfig):
    return {
        "ln": L.axes_rms_norm(),
        "w_z": logical("embed", "conv_dim", name="ssm.w_z"),
        "w_x": logical("embed", "conv_dim", name="ssm.w_x"),
        "w_bc": logical("embed", None, name="ssm.w_bc"),
        "w_dt": logical("embed", "ssm_heads", name="ssm.w_dt"),
        "dt_bias": logical("ssm_heads", name="ssm.dt_bias"),
        "A_log": logical("ssm_heads", name="ssm.A_log"),
        "D_skip": logical("ssm_heads", name="ssm.D_skip"),
        "conv_w": logical(None, "conv_dim", name="ssm.conv_w"),
        "conv_b": logical("conv_dim", name="ssm.conv_b"),
        "out_norm": {"scale": logical("conv_dim", name="ssm.out_norm")},
        "w_out": logical("conv_dim", "embed", name="ssm.w_out"),
    }


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
    """The reference's tree (``init_params(key, cfg, tp)`` as numpy,
    layers stacked) as the port's params."""
    kw = dict(f32=F32_LEAVES, dtype=dtype,
              device=torch.device("cpu" if device is None else device))
    return {k: (L.layers_from_numpy(v, cfg.num_layers, **kw)
                if k == "layers" else L.tree_from_numpy(v, **kw))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------

def _bf(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 and taken back to float32: a product's operand."""
    return t.to(L.COMPUTE_DTYPE).float()


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) log-decays -> (..., Q, Q): out[..., i, j] = sum of a[k]
    for k in (j, i] where i >= j, -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 h0: torch.Tensor | None = None):
    """Chunked SSD scan.

    x (Bt, S, H, P) value channels, dt (Bt, S, H) positive steps, A (H,)
    positive decay rates (a_t = exp(-dt A)), B and C (Bt, S, G, N) input
    and output projections (group g serves heads [g H/G, (g+1) H/G)), h0
    an optional initial state (Bt, H, P, N).  Returns (y (Bt, S, H, P)
    bf16, the last state (Bt, H, P, N) float32).
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:                       # pad: dt = 0 -> a = 1, no input
        n = chunk - S % chunk

        def pad(t):                     # n zero rows after axis 1's
            return F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, n))
        y, h_last = _ssd_chunked(pad(x), pad(dt), A, pad(B), pad(C), chunk,
                                 h0=h0)
        return y[:, :S], h_last
    nc, Q, rep = S // chunk, chunk, H // G

    def chunks(t):
        return t.reshape(Bt, nc, Q, *t.shape[2:])

    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(B), chunks(C)
    la = (-dtc * A).float()                                 # (Bt,nc,Q,H)
    decay = torch.exp(_segsum(la.transpose(2, 3)))           # (Bt,nc,H,Q,Q)

    # intra-chunk: Y = ((C B^T) ⊙ M) (dt X); C B^T once a group
    cb = torch.einsum("bcqgn,bckgn->bcgqk", _bf(Cc), _bf(Bc))
    scores = (cb[:, :, :, None] * decay.view(Bt, nc, G, rep, Q, Q)).view(
        Bt, nc, H, Q, Q)
    xdt = xc * dtc[..., None]
    y = torch.einsum("bchqk,bckhp->bcqhp", _bf(scores), _bf(xdt))

    # each chunk's contribution to the state at its end
    la_cum = torch.cumsum(la, dim=2)                          # (Bt,nc,Q,H)
    la_tot = la_cum[:, :, -1]                                 # (Bt,nc,H)
    to_end = dtc * torch.exp(la_tot[:, :, None] - la_cum)    # (Bt,nc,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3)                     # (Bt,nc,Q,H,N)
    states = torch.einsum("bcqhn,bcqhp->bchpn", _bf(Bh * to_end[..., None]),
                          _bf(xc))
    del Bh

    # across chunks: the state entering each chunk
    h = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(la_tot[:, c])[:, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1).view(Bt, nc, G, rep, P, N)

    # inter-chunk: y += C · (the incoming state, decayed to each position)
    y_inter = torch.einsum("bcqgn,bcgrpn->bcqgrp", _bf(Cc), _bf(h_in))
    y = y + y_inter.reshape(Bt, nc, Q, H, P) * torch.exp(la_cum)[..., None]
    return y.reshape(Bt, S, H, P).to(L.COMPUTE_DTYPE), h


def _conv_params(lp, cfg: ArchConfig, split: bool):
    """(conv_w (K, c), conv_b (c,)) of the c channels this model rank
    convolves: all of them, or (``split``) its ``d_inner / n`` value
    channels followed by every B/C channel.  Where "conv_dim" is split
    over "model" the taps and bias are gathered first, in one
    all-gather (every rank then holds part of their gradient, so the
    backward sums it and keeps this rank's chunk)."""
    d_inner, _ = _dims(cfg)
    full = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    n = C.model_size()
    held = L._split(lp["conv_w"].shape[1], full, n, "ssm.conv_w")
    if not (held or split):
        return lp["conv_w"], lp["conv_b"]
    wb = torch.cat([lp["conv_w"], lp["conv_b"][None]], dim=0)
    if held:
        wb = (C.gather_for_model(wb, 1) if split
              else C.gather_from_model(wb, 1))
    if split:
        k, r = d_inner // n, C.model_rank()
        wb = torch.cat([wb[:, r * k:(r + 1) * k], wb[:, d_inner:]], dim=1)
    return wb[:-1], wb[-1]


def _shares(lp, cfg: ArchConfig) -> dict:
    """The block's params this model rank runs (``layers.model_part``:
    its heads' where it runs a share of them, else all), with
    ``"split"``: whether it does."""
    d_inner, H = _dims(cfg)
    split = _heads_split(cfg)

    def part(t, full, dim, name):
        return L.model_part(t, full, dim, split, f"ssm.{name}")

    p = {name: part(lp[name], d_inner, 1, name) for name in ("w_z", "w_x")}
    p["w_dt"] = part(lp["w_dt"], H, 1, "w_dt")
    for name in ("dt_bias", "A_log", "D_skip"):
        p[name] = part(lp[name], H, 0, name)
    p["out_norm"] = part(lp["out_norm"]["scale"], d_inner, 0, "out_norm")
    p["w_out"] = part(lp["w_out"], d_inner, 0, "w_out")
    p["conv_w"], p["conv_b"] = _conv_params(lp, cfg, split)
    p["split"] = split
    return p


def _project(lp, p, cfg: ArchConfig, x: torch.Tensor):
    """The block's input projections of x -> (z, the convolution's input
    (its value channels, then B and C), dt before the softplus)."""
    h = L.rms_norm(x, lp["ln"]["scale"], cfg.norm_eps)
    if p["split"]:
        h = C.copy_to_model(h)
    conv_in = torch.cat([L.proj(h, p["w_x"]), L.proj(h, lp["w_bc"])], -1)
    return L.proj(h, p["w_z"]), conv_in, L.proj(h, p["w_dt"])


def _output(p, cfg: ArchConfig, x: torch.Tensor, y: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    """The SSM output y (B, S, the rank's d_inner) -> x + its out
    projection: the gate, the norm over d_inner, ``w_out`` (g where
    split)."""
    cd = L.COMPUTE_DTYPE
    y = y.to(cd) * F.silu(z.float()).to(cd)
    y = L.rms_norm_model(y, p["out_norm"], _dims(cfg)[0], cfg.norm_eps)
    out = L.proj(y, p["w_out"])
    return x + (C.reduce_from_model(out) if p["split"] else out)


def _block_apply(lp, cfg: ArchConfig, x: torch.Tensor, state=None):
    """One SSD block over the whole sequence x (B, S, D) -> (x + out, the
    last SSM state (B, H, P, N) float32, the convolution's input (B, S,
    conv channels) bf16); H and the channels this rank's (``_shares``)."""
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    cd = L.COMPUTE_DTYPE
    p = _shares(lp, cfg)
    H = p["dt_bias"].shape[0]
    dl = H * P
    z, conv_in, dt_raw = _project(lp, p, cfg, x)
    conv = L.causal_conv(conv_in, p["conv_w"], p["conv_b"])
    conv = F.silu(conv.float()).to(cd)
    Bt, S = x.shape[:2]
    xh = conv[..., :dl].reshape(Bt, S, H, P)
    Bg = conv[..., dl:dl + G * N].reshape(Bt, S, G, N)
    Cg = conv[..., dl + G * N:].reshape(Bt, S, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = torch.exp(p["A_log"].float())
    y, h_last = _ssd_chunked(xh, dt, A, Bg, Cg, min(cfg.ssm_chunk, S),
                             h0=state)
    y = y + xh * p["D_skip"].to(cd)[None, None, :, None]
    return _output(p, cfg, x, y.reshape(Bt, S, dl), z), h_last, conv_in


def _run(params, cfg: ArchConfig, tokens: torch.Tensor, cache=None, *,
         tp: int = 1):
    """Embed and run every block -> (the last hidden state, each block's
    last SSM state); with ``cache``, each block's state and convolution
    tail are written there."""
    x = L.embed(params["embed"], tokens, cfg.vocab_padded(tp))
    states = []
    for i, lp in enumerate(params["layers"]):
        x, st, conv_in = L.run_block(cfg.remat and x.requires_grad,
                                     _block_apply, lp, cfg, x)
        states.append(st)
        if cache is not None:
            cache["ssm"][i] = st
            cache["conv"][i] = L.conv_tail(conv_in, cfg.ssm_conv)
    return x, states


def forward(params, cfg: ArchConfig, batch, *, tp: int = 1):
    """Full-sequence forward -> (logits (B, S, Vp) bf16, each block's
    last SSM state)."""
    tokens = L.token_ids(batch["tokens"], params["embed"]["table"].device)
    x, states = _run(params, cfg, tokens, tp=tp)
    return L.lm_logits(params, cfg, x, vocab=cfg.vocab_padded(tp)), states


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

def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int = 0, *,
               tp: int = 1, device=None):
    """Each block's SSM state (L, B, H, P, N) float32 and last
    ``ssm_conv - 1`` convolution inputs (L, B, K-1, C) bf16: O(1) in the
    sequence, so ``cache_len`` is unused, and no head to lay out, so
    ``tp`` is too.  On a model rank that runs its share of the heads, H
    is its heads and C its channels (``d_inner / n + 2 G N``)."""
    del cache_len, tp
    d_inner, H = _dims(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    if _heads_split(cfg):
        d_inner, H = d_inner // C.model_size(), H // C.model_size()
    dev = torch.device("cpu" if device is None else device)
    Lc = cfg.num_layers
    return {"ssm": torch.zeros((Lc, batch_size, H, P, N), device=dev),
            "conv": torch.zeros((Lc, batch_size, cfg.ssm_conv - 1,
                                 d_inner + 2 * G * N), dtype=L.COMPUTE_DTYPE,
                                device=dev),
            "pos": 0}


def cache_axes(cfg: ArchConfig, *, seq_shard: bool = False):
    return {
        "ssm": logical("layers", "batch", "ssm_heads", None, None,
                       name="cache.ssm"),
        "conv": logical("layers", "batch", None, "conv_dim",
                        name="cache.conv"),
        "pos": logical(name="cache.pos"),
    }


def prefill(params, cfg: ArchConfig, batch, *, tp: int = 1,
            cache_len: int | None = None):
    """The whole prompt -> (last-token logits (B, Vp), cache); only the
    last position is unembedded."""
    dev = params["embed"]["table"].device
    tokens = L.token_ids(batch["tokens"], dev)
    cache = init_cache(cfg, tokens.shape[0], device=dev)
    x, _ = _run(params, cfg, tokens, cache, tp=tp)
    cache["pos"] = tokens.shape[1]
    return (L.lm_logits(params, cfg, x[:, -1:],
                        vocab=cfg.vocab_padded(tp))[:, 0], cache)


def decode_step(params, cfg: ArchConfig, cache, tokens, *, tp: int = 1):
    """One token (B, 1) through the recurrence -> (logits (B, Vp), cache),
    the cache updated in place."""
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    cd = L.COMPUTE_DTYPE
    dev = params["embed"]["table"].device
    x = L.embed(params["embed"], L.token_ids(tokens, dev),
                cfg.vocab_padded(tp))
    for i, lp in enumerate(params["layers"]):
        p = _shares(lp, cfg)
        H = p["dt_bias"].shape[0]
        dl = H * P
        z, cin, dt_raw = _project(lp, p, cfg, x)
        # the window [kept inputs, this token]: oldest first, so the taps
        # (stored newest-first) run reversed
        win = torch.cat([cache["conv"][i], cin], dim=1)        # (B, K, C)
        w = p["conv_w"].float().flip(0)
        cout = (win.float() * w).sum(1) + p["conv_b"].float()
        cout = F.silu(cout).to(cd)
        xs = cout[:, :dl].reshape(-1, H, P).float()
        Bh = cout[:, dl:dl + G * N].reshape(-1, G, N)
        Ch = cout[:, dl + G * N:].reshape(-1, G, N)
        Bh = Bh.repeat_interleave(H // G, dim=1).float()       # (B, H, N)
        Ch = Ch.repeat_interleave(H // G, dim=1).float()
        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
        a = torch.exp(-dt * torch.exp(p["A_log"].float()))
        upd = torch.einsum("bhn,bhp->bhpn", Bh, xs * dt[..., None])
        ssm = cache["ssm"][i] * a[..., None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", Ch, ssm)
        y = y + xs * p["D_skip"].float()[None, :, None]
        x = _output(p, cfg, x, y.reshape(-1, 1, dl), z)
        cache["ssm"][i] = ssm
        cache["conv"][i] = win[:, 1:]
    cache["pos"] = int(cache["pos"]) + 1
    return (L.lm_logits(params, cfg, x, vocab=cfg.vocab_padded(tp))[:, 0],
            cache)


__all__ = ["F32_LEAVES", "MODEL_PARTIAL", "cache_axes", "decode_step",
           "forward", "init_cache", "init_params", "loss_fn", "param_axes",
           "params_from_numpy", "partial_grad", "prefill"]
