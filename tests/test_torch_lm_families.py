"""The LM zoo's last four families in the port against the reference on
the CPU: llava-next-34b (VLM: patch embeddings before the text),
mamba2-1.3b (SSM: chunked SSD and its recurrence), recurrentgemma-2b
(hybrid: RG-LRU blocks and local attention) and whisper-large-v3
(encoder-decoder), at their reduced shapes (2 layers, 3 for the hybrid;
d_model 64, head_dim 16, vocab 251; SSM state 16, chunk 8; LRU width 64,
window 8; 2 encoder layers over 12 frames; 6 patches).

The reference's params (``init_params(PRNGKey(0), cfg, tp=1)``) are
carried across as numpy with each module's ``params_from_numpy``, so both
packages compute the same function; its model functions are compiled
with ``xla_allow_excess_precision`` off, so that they round every bf16
intermediate as the port does.  Tokens, frames and patches come from
numpy seeds.  Bars:

* Configs: exact.  Init trees: the same keys and shapes.
* Whole models: logits within 0.05 of the largest reference logit
  (``tests/test_decode_consistency.py``); ``loss_fn`` within 1e-4
  relative; one train step's loss within 1e-3 and grad norm within 5e-3
  relative (``tests/test_torch_lm_train.py``).
* The SSD against a sequential SSM recurrence in float64, and the
  doubling RG-LRU scan against a sequential one: within 2e-2 of the
  largest output (bf16 products in the SSD) and 1e-5 (float32 scan, whose
  sums run in another order).
"""

import dataclasses
import functools
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402

ARCHS = ("llava-next-34b", "mamba2-1.3b", "recurrentgemma-2b",
         "whisper-large-v3")
LOGITS_REL = 0.05
STRICT = {"xla_allow_excess_precision": False}
B, S, STEPS = 2, 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """(port, reference) reduced configs of ``arch`` with ``kw``."""
    return (dataclasses.replace(get_arch(arch).reduced(), **kw),
            dataclasses.replace(jget_arch(arch).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """The reference's init (PRNGKey(0), tp = 1) of the reduced ``arch``
    as numpy."""
    _, jcfg = _cfgs(arch)
    init = jax.jit(lambda k: JA.module_for(jcfg).init_params(k, jcfg, tp=1))
    return jax.tree.map(np.array, init(jax.random.PRNGKey(0)))


def _params(arch, cfg, dtype=torch.bfloat16):
    """(port params, reference params as jax arrays) of one init."""
    tree = _ref_tree(arch)
    return (TA.module_for(cfg).params_from_numpy(tree, cfg, dtype=dtype),
            jax.tree.map(jnp.asarray, tree))


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _batch(cfg, seed, Bn=B, Sn=S, labels=False):
    """Tokens (and labels) of ``Bn`` x ``Sn``, with the stub frontends'
    patches (x 0.02) or frames (x 0.1) where the family reads them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (Bn, Sn)).astype(
        np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (Bn, Sn)).astype(
            np.int32)
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal(
            (Bn, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (Bn, cfg.enc_frames, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


# ---------------------------------------------------------------------------
# configs, registry and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    """Exact: the full config and its ``reduced()`` equal the reference's
    field for field, with the same parameter counts and padded vocab; the
    arch is registered and its family has a module."""
    for mk in (lambda g: g(arch), lambda g: g(arch).reduced()):
        mine, ref = mk(get_arch), mk(jget_arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.num_params() == ref.num_params()
        assert mine.vocab_padded(1) == ref.vocab_padded(1)
    assert arch in list_archs()
    assert TA.module_for(get_arch(arch)).__name__.rsplit(".", 1)[1] == \
        JA.module_for(jget_arch(arch)).__name__.rsplit(".", 1)[1]


def _shapes(tree, prefix=()):
    """{path: shape} of a param tree; a list of layers (the port's) and a
    stacked leading axis (the reference's) both become one entry with
    the layer count first."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
    elif isinstance(tree, list):
        for path, shape in _shapes(tree[0], prefix).items():
            out[path] = (len(tree),) + shape
    else:
        out[prefix] = tuple(tree.shape)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """The port's own init has the reference's keys and shapes (its
    stacked layer axes as lists), and the reference's deterministic
    leaves: norm scales one, biases zero, mamba2's step and decay grids
    and recurrentgemma's Lambda grid equal within 1e-6."""
    cfg, jcfg = _cfgs(arch)
    mine = TA.module_for(cfg).init_params(cfg, seed=1)
    assert _shapes(mine) == _shapes(jax.eval_shape(
        lambda k: JA.module_for(jcfg).init_params(k, jcfg, tp=1),
        jax.random.PRNGKey(1)))
    ref = _ref_tree(arch)
    if arch == "mamba2-1.3b":
        for name in ("dt_bias", "A_log", "D_skip"):
            np.testing.assert_allclose(mine["layers"][1][name].numpy(),
                                       ref["layers"][name][1], atol=1e-6)
            assert mine["layers"][0][name].dtype == torch.float32
        assert mine["layers"][0]["w_x"].dtype == torch.bfloat16
    if arch == "recurrentgemma-2b":
        lp = mine["super"]["rec1"][0]
        np.testing.assert_allclose(lp["lam"].numpy(),
                                   ref["super"]["rec1"]["lam"][0], atol=1e-6)
        assert lp["wa"].dtype == torch.float32
    if arch == "whisper-large-v3":
        lp = mine["dec_layers"][0]
        assert not lp["cross_attn"]["bo"].any()
        assert not lp["ln_x"]["bias"].any() and lp["ln_x"]["scale"].all()
        assert lp["mlp"]["b_in"].dtype == torch.bfloat16


def test_the_dwn_family_raises_naming_item_8_5():
    """Queue 1 item 8.5 is done: the DWN family no longer raises but runs
    through ``dwn_arch`` behind the same interface (``module_for`` of a
    registered DWN arch, its prefill and train step); no LM arch is left
    unported, and a family the port does not have still raises."""
    from repro_torch.configs import registry
    assert registry.NOT_PORTED == ()
    cfg = get_arch("dwn-jsc-sm10")
    mod = TA.module_for(cfg)
    assert mod.__name__ == "repro_torch.models.dwn_arch"
    params = mod.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 16)).astype(np.float32))
    counts, cache = TA.make_prefill(cfg)(params, {"features": x})
    assert counts.shape == (32, 5) and counts.le(2).all() \
        and counts.ge(0).all()
    assert int(cache["pos"]) == 0
    step, opt = TA.make_train_step(cfg)
    labels = torch.zeros(32, dtype=torch.int32)
    _, _, metrics = step(params, opt.init(params),
                         {"features": x, "labels": labels})
    assert torch.isfinite(metrics["loss"])
    with pytest.raises(NotImplementedError, match="family 'nope'"):
        TA.module_for(dataclasses.replace(cfg, family="nope"))


# ---------------------------------------------------------------------------
# whole models against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Logits within 0.05 relative and ``loss_fn`` within 1e-4 relative of
    the reference's (llava's logits over its 6 patch positions and 32
    text positions, its loss over the text alone)."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg)
    batch = _batch(cfg, 1, labels=True)
    mod, jmod = TA.module_for(cfg), JA.module_for(jcfg)
    logits = mod.forward(params, cfg, batch)[0]
    jl, jloss = _strict(lambda p, b: (jmod.forward(p, jcfg, b, tp=1)[0],
                                      jmod.loss_fn(p, jcfg, b, tp=1)),
                        jp, _jnp(batch))
    assert logits.dtype == torch.bfloat16 and logits.shape == jl.shape
    assert _rel(logits, jl) < LOGITS_REL, _rel(logits, jl)
    loss = mod.loss_fn(params, cfg, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * float(jloss)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_reference(arch):
    """Prefill's last logits, then four decode steps fed the same tokens
    in both packages: each step's logits within 0.05 relative of the
    reference's, and the last within 0.05 of the port's own ``forward``
    on the 36 tokens.  The prompt is 32 tokens, a multiple of the hybrid's
    8-token window (the one length at which the reference's ring is
    aligned, fault 11)."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg)
    mod, jmod = TA.module_for(cfg), JA.module_for(jcfg)
    batch = _batch(cfg, 3)
    feed = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    lg, cache = TA.make_prefill(cfg, cache_len=S + STEPS)(params, batch)
    jlg, jcache = _strict(lambda p, b: jmod.prefill(
        p, jcfg, b, tp=1, cache_len=S + STEPS), jp, _jnp(batch))
    assert _rel(lg, jlg) < LOGITS_REL
    jdecode = jax.jit(lambda p, c, t: jmod.decode_step(p, jcfg, c, t, tp=1)
                      ).lower(jp, jcache, feed[0]).compile(
                          compiler_options=STRICT)
    decode = TA.make_decode_step(cfg)
    for t in range(STEPS):
        lg, cache = decode(params, cache, {"tokens": feed[t]})
        jlg, jcache = jdecode(jp, jcache, feed[t])
        assert _rel(lg, jlg) < LOGITS_REL, (t, _rel(lg, jlg))
    assert cache["pos"] == int(jcache["pos"])
    full = dict(batch, tokens=np.concatenate(
        [batch["tokens"], feed[:, :, 0].T], axis=1))
    want = mod.forward(params, cfg, full)[0][:, -1]
    assert _rel(lg, want.float().numpy()) < LOGITS_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step (AdamW 3e-4, clip 1.0) from the
    reference's float32 init on 4 x 16 tokens (zero patches or frames, as
    the train CLIs feed them): loss within 1e-3 and grad norm within 5e-3
    relative of the reference's; the params move."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg, dtype=torch.float32)
    raw = _batch(cfg, 8, Bn=4, Sn=16, labels=True)
    for name in ("patches", "frames"):
        if name in raw:
            raw[name] = np.zeros_like(raw[name])
    jstep, jopt = JA.make_train_step(jcfg, 1)
    _, _, jm = _strict(jstep, jp, jopt.init(jp), _jnp(raw))
    step, opt = TA.make_train_step(cfg)
    before = params["embed"]["table"].clone()
    _, _, m = step(params, opt.init(params), raw)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-3 * float(jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        5e-3 * float(jm["grad_norm"])
    assert not torch.equal(params["embed"]["table"], before)


# ---------------------------------------------------------------------------
# twins of tests/test_decode_consistency.py
# ---------------------------------------------------------------------------

def test_whisper_prefill_decode_matches():
    """Twin of ``test_whisper_prefill_decode_matches``: the reference's
    init and inputs (tokens and frames from ``PRNGKey(0)``), prefill of
    16 tokens (cache_len 20) and one decode step against the last logits
    of ``decode_train`` on the 17 tokens, within 0.05, in the port and
    against the reference's ``decode_train``."""
    cfg, jcfg = _cfgs("whisper-large-v3")
    key = jax.random.PRNGKey(0)
    params, jp = _params("whisper-large-v3", cfg)
    toks = np.asarray(jax.random.randint(key, (2, 16), 0, cfg.vocab_size))
    frames = np.asarray(jax.random.normal(
        key, (2, cfg.enc_frames, cfg.d_model), jnp.float32) * 0.1)
    _, cache = TW.prefill(params, cfg, {"tokens": toks, "frames": frames},
                          cache_len=20)
    nxt = np.full((2, 1), 5, np.int32)
    got, _ = TW.decode_step(params, cfg, cache, nxt)
    toks2 = np.concatenate([toks, nxt], 1)
    enc = TW.encode(params, cfg, frames)
    want = TW.decode_train(params, cfg, toks2, enc)[:, -1]
    assert _rel(got, want.float().numpy()) < LOGITS_REL
    jenc = JW.encode(jp, jcfg, jnp.asarray(frames), tp=1)
    jwant, _, _ = JW.decode_train(jp, jcfg, jnp.asarray(toks2), jenc, tp=1)
    assert _rel(got, jwant[:, -1]) < LOGITS_REL


def test_multistep_decode_mamba2():
    """Twin of ``test_multistep_decode_mamba2``: prefill of 24 tokens and
    four decode steps (tokens 3-6) against the last logits of ``forward``
    on the 28 tokens, within 0.05 of the largest, in the port and against
    the reference's forward."""
    cfg, jcfg = _cfgs("mamba2-1.3b")
    params, jp = _params("mamba2-1.3b", cfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 24), 0,
                                         cfg.vocab_size))
    _, cache = TM.prefill(params, cfg, {"tokens": toks})
    for t in range(4):
        nxt = np.full((2, 1), 3 + t, np.int32)
        lg, cache = TM.decode_step(params, cfg, cache, nxt)
        toks = np.concatenate([toks, nxt], 1)
    want = TM.forward(params, cfg, {"tokens": toks})[0][:, -1]
    assert _rel(lg, want.float().numpy()) < LOGITS_REL
    jwant, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, tp=1)
    assert _rel(lg, jwant[:, -1]) < LOGITS_REL


# ---------------------------------------------------------------------------
# the scans against sequential recurrences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_,chunk", [(21, 8), (8, 8), (5, 8)])
def test_ssd_matches_a_sequential_recurrence(S_, chunk):
    """``_ssd_chunked`` (padded to a chunk multiple where S is not one)
    from a random initial state against h_t = exp(-dt_t A) h_{t-1} + dt_t
    x_t B_t^T, y_t = C_t h_t, stepped in float64 on the bf16-rounded
    inputs: y within 2e-2 of its largest value (bf16 operands of the
    products) and the last state within 2e-2 of its largest."""
    rng = np.random.default_rng(S_)
    Bt, H, P, G, N = 2, 4, 8, 2, 16
    x = torch.from_numpy(rng.standard_normal((Bt, S_, H, P))).to(
        torch.bfloat16)
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, (Bt, S_, H))).float()
    A = torch.from_numpy(rng.uniform(0.5, 4.0, H)).float()
    Bm, Cm = (torch.from_numpy(rng.standard_normal((Bt, S_, G, N))).to(
        torch.bfloat16) for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((Bt, H, P, N))).float()
    y, h_last = TM._ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=h0)
    assert y.shape == (Bt, S_, H, P) and y.dtype == torch.bfloat16
    xd, dd, Ad = x.double(), dt.double(), A.double()
    Bh = Bm.double().repeat_interleave(H // G, dim=2)
    Ch = Cm.double().repeat_interleave(H // G, dim=2)
    h = h0.double()
    want = torch.zeros((Bt, S_, H, P), dtype=torch.float64)
    for t in range(S_):
        a = torch.exp(-dd[:, t] * Ad)                           # (Bt, H)
        h = h * a[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xd[:, t] * dd[:, t, :, None], Bh[:, t])
        want[:, t] = torch.einsum("bhpn,bhn->bhp", h, Ch[:, t])
    assert _rel(y, want.numpy()) < 2e-2
    assert _rel(h_last, h.numpy()) < 2e-2


@pytest.mark.parametrize("S_", [1, 7, 64, 100])
def test_rglru_doubling_scan_matches_a_sequential_one(S_):
    """``_rglru_scan`` (ceil(log2 S) passes) from a random state against
    the one-step recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t x_t in
    float32: h within 1e-5 of its largest value (the sums run in another
    order) and the last state likewise."""
    rng = np.random.default_rng(S_)
    Bt, W = 2, 16
    xw = torch.from_numpy(rng.standard_normal((Bt, S_, W))).float()
    r, i = (torch.from_numpy(rng.uniform(0, 1, (Bt, S_, W))).float()
            for _ in range(2))
    lam = torch.linspace(2.2, 6.9, W)
    h0 = torch.from_numpy(rng.standard_normal((Bt, W))).float()
    got, last = TR._rglru_scan(xw, r, i, lam, h0=h0)
    a = torch.exp(TR.LRU_C * r * torch.nn.functional.logsigmoid(lam))
    b = torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * (i * xw)
    h, want = h0.clone(), torch.zeros_like(xw)
    for t in range(S_):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    assert _rel(got, want.numpy()) < 1e-5
    assert _rel(last, h.numpy()) < 1e-5


# ---------------------------------------------------------------------------
# fault 11: the local-attention ring after prefill (recurrentgemma)
# ---------------------------------------------------------------------------

def _prng_case(arch, S_):
    """Reduced ``arch`` with ``tests/test_decode_consistency.py``'s inputs:
    init and tokens ``jax.random.randint(PRNGKey(0), (2, S))``, next token
    7.  Returns (port cfg, reference cfg, port params, reference params,
    tokens of S + 1)."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, S_), 0,
                                         cfg.vocab_size))
    toks = np.concatenate([toks, np.full((2, 1), 7, toks.dtype)], 1)
    return cfg, jcfg, params, jp, toks.astype(np.int32)


def _ref_decode_error(jmod, jcfg, jp, toks, cache_len):
    """The reference's prefill of all but the last token and one decode
    step against its ``forward`` on all of them (relative error)."""
    S_ = toks.shape[1] - 1
    _, jc = jmod.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S_])},
                         tp=1, cache_len=cache_len)
    jd, _ = jmod.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, S_:]), tp=1)
    jf, _ = jmod.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, tp=1)
    return _rel(jd, jf[:, -1])


#: the reference's relative error after an S-token prompt, cache_len S + 4
#: (an 8-slot ring under the 8-token window); 0.0050 at S = 32, a
#: multiple of the window
REF_RING_ERRORS = {33: 0.322, 36: 0.149}


@pytest.mark.parametrize("S_", sorted(REF_RING_ERRORS))
def test_local_window_prefill_keeps_the_ring_aligned(S_):
    """Reduced recurrentgemma (window 8), prompts of 33 and 36 tokens,
    cache_len S + 4: the port's prefill and one decode step give
    ``forward``'s last logits on S + 1 tokens within 0.05.  The
    reference's decode
    is off by 0.322 of the largest logit at S = 33 and 0.149 at 36: its
    prefill keeps the last window in order while its decode writes slot
    pos % 8 (fault 11)."""
    cfg, jcfg, params, jp, toks = _prng_case("recurrentgemma-2b", S_)
    _, cache = TR.prefill(params, cfg, {"tokens": toks[:, :S_]},
                          cache_len=S_ + 4)
    assert cache["k"].shape[2] == 8
    got, _ = TR.decode_step(params, cfg, cache, toks[:, S_:])
    full, _ = TR.forward(params, cfg, {"tokens": toks})
    assert _rel(got, full[:, -1].float().numpy()) < LOGITS_REL
    ref_err = _ref_decode_error(JR, jcfg, jp, toks, S_ + 4)
    assert abs(ref_err - REF_RING_ERRORS[S_]) < 0.01, ref_err


def test_local_window_ring_positions_match_the_prompt(monkeypatch):
    """After a 13-token prompt over the 8-token window, slot p % 8 of each
    attention layer's ring holds the k of position p (the last 8), the
    k a full-sequence forward computes there."""
    cfg, _, params, _, toks = _prng_case("recurrentgemma-2b", 13)
    _, cache = TR.prefill(params, cfg, {"tokens": toks[:, :13]},
                          cache_len=16)
    ks = {}
    orig = TR._attn_block

    def spy(lp, cfg_, layout, x, positions):
        out = orig(lp, cfg_, layout, x, positions)
        ks[len(ks)] = out[1]
        return out
    monkeypatch.setattr(TR, "_attn_block", spy)
    TR.forward(params, cfg, {"tokens": toks[:, :13]})
    assert len(ks) == 1
    slots = np.arange(5, 13) % 8
    for i, k in ks.items():
        assert torch.equal(cache["k"][i][:, slots], k[:, 5:])


def test_a_full_local_ring_shorter_than_the_window_raises():
    """A 6-token prompt with no cache_len gives a 6-slot ring under the
    8-token window: the reference's first decode step overwrites position
    0, which the window still reads (0.277 of the largest logit off; 0.0061
    with cache_len 10); the port's raises ``ValueError``, and with
    cache_len 10 it is right."""
    cfg, jcfg, params, jp, toks = _prng_case("recurrentgemma-2b", 6)
    assert abs(_ref_decode_error(JR, jcfg, jp, toks, None) - 0.277) < 0.01
    _, cache = TR.prefill(params, cfg, {"tokens": toks[:, :6]})
    assert cache["k"].shape[2] == 6
    with pytest.raises(ValueError, match="shorter than the 8-token window"):
        TR.decode_step(params, cfg, cache, toks[:, 6:])
    _, cache = TR.prefill(params, cfg, {"tokens": toks[:, :6]},
                          cache_len=10)
    got, _ = TR.decode_step(params, cfg, cache, toks[:, 6:])
    full, _ = TR.forward(params, cfg, {"tokens": toks})
    assert _rel(got, full[:, -1].float().numpy()) < LOGITS_REL


# ---------------------------------------------------------------------------
# fault 12: mamba2 after a prompt shorter than the convolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_", [1, 2])
def test_mamba2_decodes_after_a_short_prompt(S_):
    """Prompts of 1 and 2 tokens, shorter than ``ssm_conv - 1`` = 3: the
    port's prefill keeps the convolution's inputs left-padded with zeros
    to 3 rows, and one decode step gives the reference's ``forward`` last
    logits on S + 1 tokens within 0.05.  The reference keeps the short
    tail, so its decode step raises ``TypeError`` (fault 12; at S = 3, 9
    and 24 its error is 0.007-0.009)."""
    cfg, jcfg, params, jp, toks = _prng_case("mamba2-1.3b", S_)
    _, cache = TM.prefill(params, cfg, {"tokens": toks[:, :S_]})
    assert cache["conv"].shape[2] == cfg.ssm_conv - 1
    assert not cache["conv"][:, :, :3 - S_].any()
    got, _ = TM.decode_step(params, cfg, cache, toks[:, S_:])
    jf, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, tp=1)
    assert _rel(got, jf[:, -1]) < LOGITS_REL
    with pytest.raises(TypeError, match="incompatible shapes"):
        _ref_decode_error(JM, jcfg, jp, toks, None)


# ---------------------------------------------------------------------------
# engine and CLIs
# ---------------------------------------------------------------------------

def _greedy(params, cfg, batch, gen):
    """The port model's own greedy loop: prefill, then gen decode steps."""
    mod = TA.module_for(cfg)
    lg, cache = mod.prefill(params, cfg, batch,
                            cache_len=batch["tokens"].shape[1] + gen)
    out = []
    for _ in range(gen):
        nxt = lg[:, :cfg.vocab_size].argmax(-1)[:, None]
        out.append(nxt)
        lg, cache = mod.decode_step(params, cfg, cache, nxt)
    return torch.cat(out, 1).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_serve_cli_on_the_cpu(arch):
    """``ServingEngine(arch, reduced=True, device="cpu")`` generates the
    model's own greedy tokens on its params (recurrentgemma with a prompt
    of 10 over its 8-token window, so the ring wraps unaligned); its
    requests carry the stub frontend's bf16 patches or frames; the
    reference's ``lm-generate`` report; ``launch.serve --reduced --device
    cpu`` prints one JSON line of the arch's tokens."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine
    prompt = 10 if arch == "recurrentgemma-2b" else 8
    eng = ServingEngine(arch, reduced=True, device="cpu", prompt_len=prompt,
                        gen=3, seed=1)
    req = eng.make_request(2, seed=5)
    stub = {"vlm": ("patches", eng.cfg.num_patches),
            "encdec": ("frames", eng.cfg.enc_frames)}.get(eng.cfg.family)
    if stub:
        assert req[stub[0]].shape == (2, stub[1], eng.cfg.d_model)
        assert req[stub[0]].dtype == torch.bfloat16
    assert set(req) == {"tokens"} | ({stub[0]} if stub else set())
    eng.submit(req)
    done = eng.drain()
    np.testing.assert_array_equal(done[0].result["tokens"],
                                  _greedy(eng.params, eng.cfg, req, 3))
    rep = eng.report()
    assert rep["mode"] == "lm-generate" and rep["family"] == eng.cfg.family
    assert rep["arch"] == f"{arch}-reduced" and rep["served"] == 2
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", str(prompt),
                           "--gen", "2"]) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["mode"] == "lm-generate" and out["arch"] == f"{arch}-reduced"
    assert out["served"] == 2 and len(out["sample"]) == 2


def test_train_cli_trains_whisper_and_a_head_needs_a_transformer(capsys):
    """``launch.train --arch whisper-large-v3 --reduced --steps 2 --device
    cpu`` (zero frames, as the reference's CLI feeds them): the
    reference's LM report keys, finite losses.  A DWN head on a
    non-transformer backbone raises ``ValueError`` (its features pool the
    transformer's logits)."""
    from repro_torch.launch import train
    from repro_torch.serving import ServingEngine
    assert train.main(["--arch", "whisper-large-v3", "--reduced", "--steps",
                       "2", "--seq", "16", "--batch", "2", "--device",
                       "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rep["arch"], rep["steps"], rep["device"]) == \
        ("whisper-large-v3-reduced", 2, "cpu")
    assert np.isfinite(rep["first_loss"]) and np.isfinite(rep["last_loss"])
    with pytest.raises(ValueError, match="pools the transformer's logits"):
        ServingEngine("mamba2-1.3b", reduced=True, device="cpu",
                      dwn_head="dwn-lm-head")
