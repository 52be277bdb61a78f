"""The port's LM side (configs, dense layers, transformer, serving engine
and CLI) against the reference on the CPU, at the reduced qwen3-8b shape
(2 layers, d_model 64, 4 query heads over 2 KV heads, head_dim 16).

The reference's params (``repro.models.transformer.init_params(
PRNGKey(0), cfg, tp=1)``) are carried across as numpy, so both packages
compute the same function; tokens come from numpy seeds.  Bars, the
reference's own: logits within 0.05 of the largest reference logit
(``tests/test_decode_consistency.py``); bf16 tensors (KV caches, layer
outputs) within 2e-2 and float32 within 2e-3, absolute and relative
(``tests/test_flash_kernel.py``), except where a bf16 tensor comes out of
a layer of bf16 products: there a difference of one bf16 rounding inside
the layer moves single elements by a few ulps, and the bar is 2e-2 of
the tensor's largest value (the logits' normalisation at the bf16 bar).
Configs, layouts and greedy tokens are compared exactly."""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

LOGITS_REL = 0.05
BF16_TOL = 2e-2
F32_TOL = 2e-3
B, S, STEPS = 2, 32, 4


def _cfg(attn_impl="masked"):
    return dataclasses.replace(get_arch("qwen3-8b").reduced(),
                               attn_impl=attn_impl)


def _jcfg(attn_impl="masked"):
    return dataclasses.replace(jget_arch("qwen3-8b").reduced(),
                               attn_impl=attn_impl)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's init as numpy (tree) and as jax arrays."""
    jp = JT.init_params(jax.random.PRNGKey(0), _jcfg(), tp=1)
    return jax.tree.map(np.asarray, jp), jp


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


def _bf16_close(got, want):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def _scaled_close(got, want):
    """max |got - want| within 2e-2 of max |want| (bf16 layer outputs)."""
    assert _rel(got, want) < BF16_TOL, _rel(got, want)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_copy_and_registry():
    """Exact: the port's qwen3-8b and its reduced variant equal the
    reference's field for field, with the same parameter count and padded
    vocab; all ten of the reference's LM archs are registered (the VLM,
    SSM, hybrid and encoder-decoder ones among them) and resolve to
    their family, beside the reference's DWN archs (the registry holds
    the reference's names), unknown names raise."""
    for mk in (lambda g: g("qwen3-8b"), lambda g: g("qwen3-8b").reduced()):
        mine, ref = mk(get_arch), mk(jget_arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.num_params() == ref.num_params()
        assert mine.vocab_padded(1) == ref.vocab_padded(1)
        assert mine.head_dim_ == ref.head_dim_
    from repro.configs.registry import assigned_archs, \
        list_archs as jlist_archs
    from repro_torch.configs import assigned_archs as tassigned_archs
    assert list_archs() == jlist_archs()
    assert tassigned_archs() == assigned_archs() == [
        "granite-moe-3b-a800m", "llava-next-34b", "mamba2-1.3b",
        "mixtral-8x7b", "phi3-mini-3.8b", "qwen2-7b", "qwen3-14b",
        "qwen3-8b", "recurrentgemma-2b", "whisper-large-v3"]
    for name, family in (("llava-next-34b", "vlm"), ("mamba2-1.3b", "ssm"),
                         ("recurrentgemma-2b", "hybrid"),
                         ("whisper-large-v3", "encdec")):
        assert get_arch(name).family == family
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    assert round(get_arch("qwen3-8b").num_params() / 1e9, 2) == 8.19


@pytest.mark.parametrize("q,kv,tp", [(32, 8, 1), (4, 2, 1), (6, 2, 4),
                                     (4, 4, 3), (8, 2, 16), (6, 3, 4)])
def test_head_layout_matches_reference(q, kv, tp):
    """Exact: every regime of the padded head layout."""
    assert (dataclasses.asdict(TL.make_head_layout(q, kv, tp))
            == dataclasses.asdict(JL.make_head_layout(q, kv, tp)))


def test_unported_options_raise():
    """What the port does not run raises ``NotImplementedError``, in the
    serving form and in the float32 training form: the transformer refuses
    the SSM, hybrid and enc-dec families, naming them (``api.module_for``
    sends them to their own modules).  Experts sharded over the model
    axis (``moe_ep``, item 9b.3) are ported: the params pad the 4 experts
    to 16, as the reference's do, and the model runs in both forms.  The
    DWN behind the LM interface (``family="dwn"``, item 8.5, done) goes
    to ``dwn_arch`` through ``module_for`` and ``make_train_step``; the
    dense and VLM models train."""
    cfg = _cfg()
    for bad, match in ((dict(family="ssm"), "family 'ssm'"),
                       (dict(family="hybrid"), "family 'hybrid'"),
                       (dict(family="encdec"), "family 'encdec'")):
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(NotImplementedError, match=match):
                TT.init_params(dataclasses.replace(cfg, **bad), dtype=dtype)
    ep = dataclasses.replace(cfg, family="moe", num_experts=4, top_k=2,
                             moe_ep=True)
    for dtype in (torch.bfloat16, torch.float32):
        p = TT.init_params(ep, dtype=dtype)
        assert p["layers"][0]["moe"]["w_gate"].shape[0] == 16
        logits, _, _ = TT.forward(p, ep, {"tokens": torch.zeros(
            (1, 4), dtype=torch.long)})
        assert bool(torch.isfinite(logits.float()).all())
    assert callable(api.make_train_step(
        dataclasses.replace(cfg, family="dwn"))[0])
    assert callable(api.make_train_step(cfg)[0])
    assert callable(api.make_train_step(
        dataclasses.replace(cfg, family="vlm"))[0])
    assert api.module_for(dataclasses.replace(cfg, family="dwn")).__name__ \
        == "repro_torch.models.dwn_arch"
    assert {f: api.module_for(dataclasses.replace(cfg, family=f)).__name__
            for f in ("ssm", "hybrid", "encdec", "vlm")} == {
        "ssm": "repro_torch.models.mamba2",
        "hybrid": "repro_torch.models.rglru",
        "encdec": "repro_torch.models.whisper",
        "vlm": "repro_torch.models.transformer"}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    """float32 inside, cast back: within 2e-3 (float32) or 2e-2 (bf16)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) * 37, (2, 9)).copy()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x, jdt)
    for got, want in (
            (TL.rms_norm(tx, torch.from_numpy(scale), 1e-6),
             JL.rms_norm(jx, jnp.asarray(scale), 1e-6)),
            (TL.apply_rope(tx, torch.from_numpy(pos), 1e6),
             JL.apply_rope(jx, jnp.asarray(pos), 1e6))):
        assert got.dtype == tdt
        np.testing.assert_allclose(np.asarray(got.float()),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("S,chunk", [(1, 16), (20, 8), (33, 16), (32, 32)])
def test_chunked_and_decode_attention_match_reference(S, chunk):
    """``attention_chunked`` (causal, a chunk that need not divide S) and
    ``attention_decode`` against a half-filled cache: within 2e-2 of the
    reference's (bf16 outputs)."""
    rng = np.random.default_rng(S)
    layout_t, layout_j = TL.make_head_layout(4, 2, 1), JL.make_head_layout(
        4, 2, 1)
    q, k, v = (rng.standard_normal((2, S, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    got = TL.attention_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                               layout_t, causal=True, kv_chunk=chunk)
    want = JL.attention_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                layout_j, causal=True, kv_chunk=chunk)
    _bf16_close(got, want)
    cur = max(S // 2, 1)
    got = TL.attention_decode(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                              torch.from_numpy(v), layout_t, cur_len=cur)
    want = JL.attention_decode(jnp.asarray(q[:, :1]), jnp.asarray(k),
                               jnp.asarray(v), layout_j,
                               cur_len=jnp.full((2,), cur))
    _bf16_close(got, want)


#: the largest |diff| allowed between the port's and the reference's
#: masked attention with bf16 scores: far under the 0.040 that rounding
#: the scores to bf16 moves this case by
SCORES_BF16_TOL = 4e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_scores_dtype_matches_reference(dtype):
    """``attention_chunked`` with ``scores_dtype`` (B=1, S=64, 4 query
    heads over 2 KV heads, hd 16, q and k scaled by 2, kv_chunk 32):
    float32 scores equal the reference's exactly; bf16 scores are within
    SCORES_BF16_TOL of the reference's bf16-score path and move the output
    by more than that from the float32 one, as they move the
    reference's."""
    rng = np.random.default_rng(64)
    q, k, v = (rng.standard_normal((1, 64, h, 16)).astype(np.float32) * sc
               for h, sc in ((4, 2.0), (2, 2.0), (2, 1.0)))
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got = TL.attention_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                               TL.make_head_layout(4, 2, 1), causal=True,
                               kv_chunk=32, scores_dtype=tdt)
    got = np.asarray(got.float())
    jl = JL.make_head_layout(4, 2, 1)
    want, want_f32 = (np.asarray(JL.attention_chunked(
        *(jnp.asarray(a) for a in (q, k, v)), jl, causal=True, kv_chunk=32,
        scores_dtype=d), np.float32) for d in (jdt, jnp.float32))
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= SCORES_BF16_TOL
        assert np.abs(want - want_f32).max() > 2 * SCORES_BF16_TOL
        assert np.abs(got - want_f32).max() > 2 * SCORES_BF16_TOL


def test_init_stds_dtypes_and_dead_slots():
    """The port's own init: the reference's shapes with bf16 matrices and
    float32 norm scales, stds within 10% of the reference's, and dead q
    slots of a padded layout zero in wq and wo."""
    cfg = _cfg()
    mine = TT.init_params(cfg, seed=3)
    ref = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3), _jcfg(),
                                                  tp=1))
    stds = {"wq": cfg.d_model ** -0.5, "w_down": cfg.d_ff ** -0.5,
            "table": 0.01, "w": cfg.d_model ** -0.5}
    for name, lp in (("layers", mine["layers"][0]),):
        for blk, leaves in lp.items():
            for leaf, t in leaves.items():
                want = ref["layers"][blk][leaf][0]
                assert tuple(t.shape) == want.shape, (blk, leaf)
                assert t.dtype == (torch.float32 if leaf in (
                    "scale", "q_norm", "k_norm") else torch.bfloat16)
                if leaf in stds:
                    assert abs(float(t.float().std()) / stds[leaf] - 1) < 0.1
    assert tuple(mine["embed"]["table"].shape) == ref["embed"]["table"].shape
    assert abs(float(mine["embed"]["table"].float().std()) / 0.01 - 1) < 0.1
    assert tuple(mine["unembed"]["w"].shape) == ref["unembed"]["w"].shape
    layout = TL.make_head_layout(6, 2, 4)              # 3 of 4 slots alive
    p = TL.init_attention(torch.Generator().manual_seed(0), 64, layout, 16)
    dead = torch.arange(layout.q_padded) % layout.slots >= 3
    assert dead.sum() == 2
    assert not p["wq"][:, dead].any() and not p["wo"][dead].any()
    assert p["wq"][:, ~dead].float().abs().min(dim=0).values.max() > 0


# ---------------------------------------------------------------------------
# the model: forward, prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["masked", "pallas"])
def test_forward_matches_reference(ref_params, attn_impl):
    """Full-sequence logits within 0.05 relative; the collected K/V of
    every layer within 2e-2 of their largest value.  ``pallas`` runs the reference's kernel in
    interpret mode and the port's flash attention."""
    tree, jp = ref_params
    cfg, jcfg = _cfg(attn_impl), _jcfg(attn_impl)
    params = TT.params_from_numpy(tree, cfg)
    toks = _tokens(1, (B, S), cfg.vocab_size)
    logits, aux, (k, v) = TT.forward(params, cfg, {"tokens": toks},
                                     collect_kv=True)
    jl, _, (jk, jv) = jax.jit(lambda p, t: JT.forward(
        p, jcfg, {"tokens": t}, tp=1, collect_kv=True))(jp, toks)
    assert logits.dtype == torch.bfloat16 and logits.shape == jl.shape
    assert _rel(logits, jl) < LOGITS_REL
    _scaled_close(k, jk)
    _scaled_close(v, jv)


def test_forward_with_bf16_scores_matches_reference(ref_params):
    """``attn_scores_bf16=True`` on the masked path: the port's logits
    within 0.05 relative of the reference's with the same flag, and the
    flag is read (the port's logits change with it)."""
    tree, jp = ref_params
    cfg = dataclasses.replace(_cfg(), attn_scores_bf16=True)
    jcfg = dataclasses.replace(_jcfg(), attn_scores_bf16=True)
    toks = _tokens(1, (B, S), cfg.vocab_size)
    logits, _, _ = TT.forward(TT.params_from_numpy(tree, cfg), cfg,
                              {"tokens": toks})
    plain, _, _ = TT.forward(TT.params_from_numpy(tree, _cfg()), _cfg(),
                             {"tokens": toks})
    jl, _, _ = jax.jit(lambda p, t: JT.forward(
        p, jcfg, {"tokens": t}, tp=1))(jp, toks)
    assert _rel(logits, jl) < LOGITS_REL
    assert not torch.equal(logits, plain)


@pytest.mark.parametrize("attn_impl", ["masked", "pallas"])
def test_prefill_and_teacher_forced_decode_match_reference(ref_params,
                                                           attn_impl):
    """Prefill's last logits (0.05 relative) and K/V cache (2e-2 of the
    largest value), then four decode steps fed the same tokens in both
    packages, each step's logits within 0.05 relative and the final
    caches within 2e-2 of the largest value.  The
    port's decode launches no flash-attention kernel."""
    tree, jp = ref_params
    cfg, jcfg = _cfg(attn_impl), _jcfg(attn_impl)
    params = TT.params_from_numpy(tree, cfg)
    toks = _tokens(2, (B, S), cfg.vocab_size)
    feed = _tokens(3, (STEPS, B, 1), cfg.vocab_size)
    lg, cache = api.make_prefill(cfg, cache_len=S + STEPS)(
        params, {"tokens": toks})
    jlg, jcache = jax.jit(lambda p, t: JT.prefill(
        p, jcfg, {"tokens": t}, tp=1, cache_len=S + STEPS))(jp, toks)
    assert lg.shape == jlg.shape and cache["pos"] == int(jcache["pos"]) == S
    assert _rel(lg, jlg) < LOGITS_REL
    _scaled_close(cache["k"], jcache["k"])
    _scaled_close(cache["v"], jcache["v"])
    jdecode = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c, t, tp=1))
    decode = api.make_decode_step(cfg)
    for t in range(STEPS):
        lg, cache = decode(params, cache, {"tokens": torch.from_numpy(
            feed[t])})
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(feed[t]))
        assert _rel(lg, jlg) < LOGITS_REL, (t, _rel(lg, jlg))
    assert cache["pos"] == int(jcache["pos"]) == S + STEPS
    _scaled_close(cache["k"], jcache["k"])
    _scaled_close(cache["v"], jcache["v"])


def test_prefill_refuses_a_cache_shorter_than_the_prompt():
    params = TT.init_params(_cfg(), seed=0)
    with pytest.raises(ValueError, match="shorter"):
        TT.prefill(params, _cfg(), {"tokens": np.zeros((1, 8), np.int32)},
                   cache_len=4)


# ---------------------------------------------------------------------------
# engine and CLI on the CPU
# ---------------------------------------------------------------------------

def _greedy(params, cfg, toks, gen):
    """The port model's own greedy loop: prefill, then gen decode steps."""
    lg, cache = TT.prefill(params, cfg, {"tokens": toks},
                           cache_len=toks.shape[1] + gen)
    out = []
    for _ in range(gen):
        nxt = lg[:, :cfg.vocab_size].argmax(-1)[:, None]
        out.append(nxt)
        lg, cache = TT.decode_step(params, cfg, cache, nxt)
    return torch.cat(out, 1).numpy()


@pytest.mark.parametrize("attn_impl", ["masked", "pallas"])
def test_engine_generates_the_models_greedy_tokens(attn_impl):
    """Exact: the engine's tokens are (B, gen) int32 and equal the model's
    own greedy loop on the engine's params; the report carries the
    reference's ``lm-generate`` keys (``serving/engine.py:688-699``)."""
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_arch("qwen3-8b"), attn_impl=attn_impl)
    eng = ServingEngine(cfg, reduced=True, device="cpu", prompt_len=8,
                        gen=3, seed=1)
    assert eng.family == "lm" and eng.cfg.attn_impl == attn_impl
    reqs = [eng.make_request(2, seed=s) for s in (5, 6)]
    assert reqs[0]["tokens"].shape == (2, 8)
    assert reqs[0]["tokens"].dtype == np.int32
    for r in reqs:
        eng.submit(r)
    done = eng.drain()
    assert [r.size for r in done] == [2, 2]
    for r, req in zip(done, reqs):
        toks = r.result["tokens"]
        assert toks.shape == (2, 3) and toks.dtype == np.int32
        np.testing.assert_array_equal(
            toks, _greedy(eng.params, eng.cfg, req["tokens"], 3))
    rep = eng.report()
    for key in ("mode", "prompt_len", "generated", "model_parallel",
                "prefill_s", "decode_s_per_tok"):
        assert key in rep, key
    assert rep["mode"] == "lm-generate" and rep["family"] == "dense"
    assert (rep["prompt_len"], rep["generated"], rep["served"]) == (8, 3, 4)
    assert rep["arch"] == "qwen3-8b-reduced" and rep["device"] == "cpu"
    assert FK.launch_counts() == {"flash_attention": 0}
    assert (rep["model_parallel"], rep["devices"]) == (1, 1)
    # without a process group the model axis is cut to the world: one
    # device, tp 1 (as the reference cuts it to its devices)
    cut = ServingEngine("qwen3-8b", reduced=True, device="cpu",
                        model_parallel=2)
    assert cut.tp == 1 and cut.report()["model_parallel"] == 1


def test_cli_serves_qwen3_8b_reduced_on_the_cpu():
    """The LM branch of the serve CLI: one JSON line, (batch, gen) tokens,
    the lm-generate block."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert serve.main(["--arch", "qwen3-8b", "--reduced", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "8",
                           "--gen", "2"]) == 0
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rep["mode"] == "lm-generate" and rep["batch"] == 2
    assert rep["attn_impl"] == "masked" and len(rep["sample"]) == 2
    assert rep["served"] == 2 and rep["generated"] == 2
