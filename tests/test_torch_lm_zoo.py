"""The LM zoo's dense options and MoE family in the port against the
reference on the CPU: qwen2-7b (q/k/v biases), qwen3-14b, phi3-mini-3.8b
(MHA), granite-moe-3b-a800m (MoE, tied embeddings) and mixtral-8x7b (MoE,
sliding window), at their reduced shapes (2 layers, d_model 64, 4 query
heads, head_dim 16, vocab 251; MoE 4 experts top-2).

The reference's params (``init_params(PRNGKey(0), cfg, tp=1)``) are
carried across as numpy, so both packages compute the same function.
The reference initialises q/k/v biases to zero, which would hide a
missing bias: qwen2-7b's carried biases are random.  Tokens come from
numpy seeds.  Bars:

* Configs and the layers' masks: exact.
* Attention layers: bf16 outputs within 2e-2 absolute and relative
  (``tests/test_flash_kernel.py``).
* ``moe_apply`` on the same float32 input: y within 2e-2 (bf16 products)
  and aux within 1e-6 relative (float32 softmax and means).
* Whole models: logits within 0.05 of the largest reference logit
  (``tests/test_decode_consistency.py``); aux within 1e-4 relative; loss
  within 1e-4 relative; one train step's loss within 1e-3 and grad norm
  within 5e-3 relative (``tests/test_torch_lm_train.py``).  The
  reference's model functions are compiled with
  ``xla_allow_excess_precision`` off, so that it rounds every bf16
  intermediate as the port does: with XLA's default it keeps some in
  float32, and on the reduced granite at capacity factor 1.25 that moves
  one token past its expert's capacity and two logit rows by 0.21 of the
  largest logit.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ("qwen2-7b", "qwen3-14b", "phi3-mini-3.8b", "granite-moe-3b-a800m",
         "mixtral-8x7b")
MOE_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x7b")
LOGITS_REL = 0.05
BF16_TOL = 2e-2
STRICT = {"xla_allow_excess_precision": False}


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
    """The reference's init of the reduced ``arch`` as numpy, with random
    q/k/v biases where the arch has them."""
    _, jcfg = _cfgs(arch)
    tree = jax.tree.map(np.array, JT.init_params(jax.random.PRNGKey(0),
                                                 jcfg, tp=1))
    attn = tree["layers"]["attn"]
    rng = np.random.default_rng(11)
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (rng.standard_normal(attn[name].shape) * 0.5
                          ).astype(np.float32)
    return tree


def _params(arch, cfg, dtype=torch.bfloat16):
    """(port params, reference params as jax arrays) of one init."""
    tree = _ref_tree(arch)
    return (TT.params_from_numpy(tree, cfg, dtype=dtype),
            jax.tree.map(jnp.asarray, tree))


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _tokens(seed, shape, vocab=251):
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


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    """Exact: the full config and its ``reduced()`` equal the reference's
    field for field, with the same parameter counts, padded vocab and
    head_dim; the arch is registered."""
    for mk in (lambda g: g(arch), lambda g: g(arch).reduced()):
        mine, ref = mk(get_arch), mk(jget_arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.num_params() == ref.num_params()
        assert mine.num_active_params() == ref.num_active_params()
        assert mine.vocab_padded(1) == ref.vocab_padded(1)
        assert mine.head_dim_ == ref.head_dim_
    assert arch in list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """The port's own init has the reference's tree (``moe`` in place of
    ``mlp``, q/k/v biases, no ``unembed`` when tied) and shapes; biases
    start at zero as the reference's; the router is float32 in the bf16
    serving form."""
    cfg, jcfg = _cfgs(arch)
    mine = TT.init_params(cfg, seed=1)
    ref = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(1),
                                                  jcfg, tp=1))
    assert set(mine) == set(ref)
    assert ("unembed" in mine) == (not cfg.tie_embeddings)
    for blk, sub in ref["layers"].items():
        for leaf, want in sub.items():
            got = mine["layers"][0][blk][leaf]
            assert tuple(got.shape) == want.shape[1:], (blk, leaf)
            if leaf in ("bq", "bk", "bv"):
                assert not got.any()
    if cfg.family == "moe":
        assert mine["layers"][1]["moe"]["router"].dtype == torch.float32
        assert mine["layers"][1]["moe"]["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention options
# ---------------------------------------------------------------------------

def test_qkv_bias_projection_matches_reference():
    """qwen2-7b's layer 0 with its random carried biases: q, k and v
    within 2e-2 of the reference's, and the biases move them (the same
    projection without them is farther than that)."""
    cfg, _ = _cfgs("qwen2-7b")
    attn = {k: v[0] for k, v in _ref_tree("qwen2-7b")["layers"]["attn"]
            .items()}
    x = np.random.default_rng(5).standard_normal((2, 9, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in attn.items()}
    got = TL.qkv_project(tp, torch.from_numpy(x),
                         positions=torch.from_numpy(pos), rope_theta=1e6)
    want = JL.qkv_project({k: jnp.asarray(v) for k, v in attn.items()},
                          jnp.asarray(x), JL.make_head_layout(4, 2, 1),
                          positions=jnp.asarray(pos), rope_theta=1e6)
    bare = TL.qkv_project({k: v for k, v in tp.items() if k[0] != "b"},
                          torch.from_numpy(x),
                          positions=torch.from_numpy(pos), rope_theta=1e6)
    for g, w, b in zip(got, want, bare):
        _bf16_close(g, w)
        assert _rel(b, w) > 10 * BF16_TOL


@pytest.mark.parametrize("S,chunk,window", [(20, 8, 5), (33, 16, 16),
                                            (40, 16, 7), (12, 32, 16)])
def test_window_attention_matches_reference(S, chunk, window):
    """``attention_chunked(window=)`` (causal, 4 query heads over 2 KV
    heads) within 2e-2 of the reference's, and different from the
    unwindowed path where the window cuts; ``attention_decode(window=)``
    against a ring of ``window`` slots before it fills, full and wrapped,
    within 2e-2 of the reference's."""
    rng = np.random.default_rng(S)
    lt, lj = TL.make_head_layout(4, 2, 1), JL.make_head_layout(4, 2, 1)
    q, k, v = (rng.standard_normal((2, S, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TL.attention_chunked(tq, tk, tv, lt, causal=True, window=window,
                               kv_chunk=chunk)
    want = JL.attention_chunked(*(jnp.asarray(a) for a in (q, k, v)), lj,
                                causal=True, window=window, kv_chunk=chunk)
    _bf16_close(got, want)
    full = TL.attention_chunked(tq, tk, tv, lt, causal=True, kv_chunk=chunk)
    assert torch.equal(full, got) == (S <= window)
    ring = min(S, window)
    for cur in sorted({1, ring // 2, ring, ring + 3}):
        got = TL.attention_decode(tq[:, :1], tk[:, :ring], tv[:, :ring], lt,
                                  cur_len=cur, window=window)
        want = JL.attention_decode(jnp.asarray(q[:, :1]),
                                   jnp.asarray(k[:, :ring]),
                                   jnp.asarray(v[:, :ring]), lj,
                                   cur_len=jnp.full((2,), cur),
                                   window=window)
        _bf16_close(got, want)


@pytest.mark.parametrize("S", [8, 20, 33, 64])
def test_tri_attention_matches_reference_and_chunked(S):
    """``attention_causal_tri`` at leaf 8, so that sequences longer than 8
    recurse (S = 64 three levels deep), within 2e-2 of the reference's at
    the same leaf and of the port's chunked path."""
    rng = np.random.default_rng(S + 1)
    lt, lj = TL.make_head_layout(4, 2, 1), JL.make_head_layout(4, 2, 1)
    q, k, v = (rng.standard_normal((2, S, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TL.attention_causal_tri(tq, tk, tv, lt, kv_chunk=4, leaf=8)
    want = JL.attention_causal_tri(*(jnp.asarray(a) for a in (q, k, v)), lj,
                                   kv_chunk=4, leaf=8)
    _bf16_close(got, want)
    chunked = TL.attention_chunked(tq, tk, tv, lt, causal=True, kv_chunk=4)
    _bf16_close(got, chunked.float().numpy())


# ---------------------------------------------------------------------------
# MoE: twins of tests/test_moe.py, then capacity drops against the reference
# ---------------------------------------------------------------------------

def _moe_setup(B=2, S=16, D=32, F=48, E=4, seed=0):
    """The reference's ``init_moe`` and input of ``tests/test_moe.py``, as
    numpy."""
    p = jax.tree.map(np.array, JL.init_moe(jax.random.PRNGKey(seed), D, F,
                                           E))
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (B, S, D), jnp.float32) * 0.5)
    return p, x


def _torch_moe(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _dense_reference(p, x, top_k):
    """Every expert computed densely in float32, combined with the
    renormalised top-k gates (``tests/test_moe.py``'s reference)."""
    p = _torch_moe(p)
    x = torch.from_numpy(x)
    probs = torch.softmax(x @ p["router"], -1)
    gates, idx = torch.topk(probs, top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"])
    y_all = torch.einsum("bsef,efd->bsed",
                         torch.nn.functional.silu(g) * u, p["w_down"])
    w = torch.zeros(probs.shape).scatter_(-1, idx, gates)
    return torch.einsum("bsed,bse->bsd", y_all, w).numpy()


def test_moe_matches_dense_reference_at_high_capacity(monkeypatch):
    """Capacity factor 8 drops nothing: within 0.05 of the dense float32
    reference (bf16 products), and within 2e-2 of the reference's
    ``moe_apply``; the expert products run one expert at a time when the
    chunk bound is that small, to the same output bit for bit."""
    p, x = _moe_setup()
    y, aux = TL.moe_apply(_torch_moe(p), torch.from_numpy(x), top_k=2,
                          capacity_factor=8.0)
    monkeypatch.setattr(TL, "_EXPERT_CHUNK_BYTES", 1)
    chunked, _ = TL.moe_apply(_torch_moe(p), torch.from_numpy(x), top_k=2,
                              capacity_factor=8.0)
    assert torch.equal(chunked, y)
    np.testing.assert_allclose(y.numpy(), _dense_reference(p, x, 2),
                               atol=0.05, rtol=0.05)
    jy, jaux = JL.moe_apply(p, jnp.asarray(x), top_k=2, capacity_factor=8.0)
    _bf16_close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)


def test_moe_aux_loss_near_one_for_uniform_router():
    """A zero router ties every expert: aux is about 1 (E * sum 1/E *
    1/E), and the ties break to the lowest experts as ``lax.top_k``'s
    do, so y equals the reference's within 2e-2."""
    p, x = _moe_setup(seed=3)
    p = dict(p, router=np.zeros_like(p["router"]))
    y, aux = TL.moe_apply(_torch_moe(p), torch.from_numpy(x), top_k=2,
                          capacity_factor=8.0)
    assert 0.9 < float(aux) < 1.1
    jy, _ = JL.moe_apply(p, jnp.asarray(x), top_k=2, capacity_factor=8.0)
    _bf16_close(y, jy)
    other = dict(p, w_down=p["w_down"][[2, 3, 0, 1]])
    swapped, _ = TL.moe_apply(_torch_moe(other), torch.from_numpy(x),
                              top_k=2, capacity_factor=8.0)
    assert _rel(swapped, jy) > 10 * BF16_TOL


def test_moe_capacity_drops_are_bounded():
    """At capacity factor 0.5 some slots drop; the output stays finite and
    correlates with the dense reference above 0.5."""
    p, x = _moe_setup(B=1, S=64, seed=5)
    with TL.count_moe_slots() as counts:
        y, _ = TL.moe_apply(_torch_moe(p), torch.from_numpy(x), top_k=2,
                            capacity_factor=0.5)
    assert torch.isfinite(y).all()
    (kept, routed), = counts
    assert routed == 128 and kept <= 4 * 16 < routed
    corr = np.corrcoef(y.numpy().ravel(),
                       _dense_reference(p, x, 2).ravel())[0, 1]
    assert corr > 0.5


def test_moe_gradients_finite():
    """The output's and aux's gradients are finite in every leaf and reach
    the router (through the gates)."""
    p, x = _moe_setup(seed=7)
    tp = {k: v.requires_grad_() for k, v in _torch_moe(p).items()}
    y, aux = TL.moe_apply(tp, torch.from_numpy(x), top_k=2)
    ((y.float() ** 2).mean() + 0.01 * aux).backward()
    for k, leaf in tp.items():
        assert torch.isfinite(leaf.grad).all(), k
    assert tp["router"].grad.abs().max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_drops_match_reference_at_capacity_1_25(seed):
    """Capacity factor 1.25 on a router skewed towards expert 0 (S = 64,
    top-2, 4 experts: 40 slots an expert): slots are dropped, and y is
    within 2e-2 of the reference's and aux within 1e-6 relative, so the
    same slots dropped; the same without the skew drops fewer."""
    p, x = _moe_setup(B=2, S=64, seed=seed)
    p["router"][:, 0] += 0.5 * np.sign(x.mean((0, 1)))
    with TL.count_moe_slots() as counts:
        y, aux = TL.moe_apply(_torch_moe(p), torch.from_numpy(x), top_k=2,
                              capacity_factor=1.25)
    jy, jaux = JL.moe_apply(p, jnp.asarray(x), top_k=2, capacity_factor=1.25)
    (kept, routed), = counts
    assert kept < routed
    _bf16_close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)
    full, _ = TL.moe_apply(_torch_moe(p), torch.from_numpy(x), top_k=2,
                           capacity_factor=8.0)
    assert _rel(y, full.float().numpy()) > 10 * BF16_TOL


def test_moe_expert_parallel_raises_naming_item_9():
    """``moe_ep=True`` (expert parallelism, item 9b.3, now ported) on one
    device: with the experts padded to 16, as the reference's transformer
    pads them, ``moe_apply``'s float32 scatter-add combine within the
    bf16 bar of the reference's ``ep=True`` and its aux loss within 1e-6
    relative; the model's params pad mixtral's experts the same way, with
    the reference's shapes."""
    p = jax.tree.map(np.array, JL.init_moe(jax.random.PRNGKey(0), 32, 48, 4,
                                           pad_to=16))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32),
                                   jnp.float32) * 0.5)
    y, aux = TL.moe_apply(_torch_moe(p), torch.from_numpy(x), top_k=2,
                          num_real_experts=4, ep=True)
    jy, jaux = jax.jit(lambda p, x: JL.moe_apply(
        p, x, top_k=2, num_real_experts=4, ep=True))(p, x)
    _bf16_close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)
    cfg, jcfg = _cfgs("mixtral-8x7b", moe_ep=True)
    got = TT.init_params(cfg, device="meta")["layers"][0]["moe"]
    want = jax.eval_shape(lambda k: JT.init_params(k, jcfg, tp=1),
                          jax.random.PRNGKey(0))["layers"]["moe"]
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape[1:]) for k, v in want.items()}
    assert got["w_gate"].shape[0] == 16


# ---------------------------------------------------------------------------
# whole models against the reference
# ---------------------------------------------------------------------------

B, S, STEPS = 2, 32, 4


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Logits within 0.05 relative, the summed aux within 1e-4 relative
    (0.0 for the dense archs) and ``loss_fn`` (cross-entropy plus 0.01
    aux) within 1e-4 relative of the reference's."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg)
    toks = _tokens(1, (B, S))
    labels = _tokens(2, (B, S))
    logits, aux, _ = TT.forward(params, cfg, {"tokens": toks})
    jl, jaux, _ = _strict(lambda p, t: JT.forward(p, jcfg, {"tokens": t},
                                                  tp=1), jp, toks)
    assert logits.dtype == torch.bfloat16 and logits.shape == jl.shape
    assert _rel(logits, jl) < LOGITS_REL, _rel(logits, jl)
    if cfg.family == "moe":
        assert abs(float(aux) - float(jaux)) <= 1e-4 * float(jaux)
        assert float(aux) > 1.0
    else:
        assert aux == 0.0 and float(jaux) == 0.0
    batch = {"tokens": toks, "labels": labels}
    loss = TT.loss_fn(params, cfg, batch)
    jloss = _strict(lambda p, b: JT.loss_fn(p, jcfg, b, tp=1), jp,
                    {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-4 * float(jloss)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_reference(arch):
    """Prefill's last logits and K/V cache, then four decode steps fed the
    same tokens in both packages: each step's logits within 0.05 relative
    and the caches within 2e-2 of their largest value.  The prompt is 32
    tokens, a multiple of mixtral's reduced 16-token window, the one
    length at which the reference's ring is aligned (fault 10)."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg)
    toks = _tokens(3, (B, S))
    feed = _tokens(4, (STEPS, B, 1))
    lg, cache = TA.make_prefill(cfg, cache_len=S + STEPS)(
        params, {"tokens": toks})
    jlg, jcache = _strict(lambda p, t: JT.prefill(
        p, jcfg, {"tokens": t}, tp=1, cache_len=S + STEPS), jp, toks)
    assert cache["k"].shape == jcache["k"].shape
    assert _rel(lg, jlg) < LOGITS_REL
    jdecode = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c, t, tp=1)
                      ).lower(jp, jcache, feed[0]).compile(
                          compiler_options=STRICT)
    decode = TA.make_decode_step(cfg)
    for t in range(STEPS):
        lg, cache = decode(params, cache, {"tokens": feed[t]})
        jlg, jcache = jdecode(jp, jcache, feed[t])
        assert _rel(lg, jlg) < LOGITS_REL, (t, _rel(lg, jlg))
    assert cache["pos"] == int(jcache["pos"]) == S + STEPS
    for name in ("k", "v"):
        assert _rel(cache[name], jcache[name]) < BF16_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Twin of ``tests/test_decode_consistency.py``'s case: prefill of 32
    tokens (cache_len 36) and one decode step give the last logits of
    ``forward`` on the 33 tokens within 0.05 relative, in the port and
    against the reference's forward; MoE at capacity factor 8, as the
    reference's test sets it, so that the 32- and 33-token passes drop
    nothing."""
    kw = {"capacity_factor": 8.0} if arch in MOE_ARCHS else {}
    cfg, jcfg = _cfgs(arch, **kw)
    params, jp = _params(arch, cfg)
    toks = _tokens(5, (B, S + 1))
    _, cache = TT.prefill(params, cfg, {"tokens": toks[:, :S]},
                          cache_len=S + 4)
    got, _ = TT.decode_step(params, cfg, cache, toks[:, S:])
    full, _, _ = TT.forward(params, cfg, {"tokens": toks})
    jfull, _, _ = _strict(lambda p, t: JT.forward(p, jcfg, {"tokens": t},
                                                  tp=1), jp, toks)
    assert _rel(got, full[:, -1].float().numpy()) < LOGITS_REL
    assert _rel(got, jfull[:, -1]) < LOGITS_REL


def test_tri_equals_masked_end_to_end():
    """Twin of ``test_attention_tri_equals_masked_end_to_end`` on qwen2-7b
    with its biases, at leaf 16 through ``attn_chunk`` 8 and 48 tokens:
    ``attn_impl="tri"`` gives the masked path's logits within 0.05, and
    the reference's ``tri`` logits within 0.05."""
    cfg, jcfg = _cfgs("qwen2-7b")
    params, jp = _params("qwen2-7b", cfg)
    toks = _tokens(6, (B, 48))
    a, _, _ = TT.forward(params, cfg, {"tokens": toks})
    tri = dataclasses.replace(cfg, attn_impl="tri")
    b, _, _ = TT.forward(params, tri, {"tokens": toks})
    jb, _, _ = _strict(lambda p, t: JT.forward(
        p, dataclasses.replace(jcfg, attn_impl="tri"), {"tokens": t}, tp=1),
        jp, toks)
    assert _rel(b, a.float().numpy()) < LOGITS_REL
    assert _rel(b, jb) < LOGITS_REL


def test_pallas_skips_the_kernel_under_a_window():
    """mixtral under ``attn_impl="pallas"`` takes the windowed chunked path
    (as the reference's does): the same logits as ``masked`` bit for bit,
    and no flash-attention launch; without the window the pallas path
    differs from the windowed one."""
    cfg, _ = _cfgs("mixtral-8x7b")
    params, _ = _params("mixtral-8x7b", cfg)
    toks = _tokens(7, (B, 40))
    FK.reset_launch_counts()
    a, _, _ = TT.forward(params, cfg, {"tokens": toks})
    b, _, _ = TT.forward(params, dataclasses.replace(cfg, attn_impl="pallas"),
                         {"tokens": toks})
    assert torch.equal(a, b)
    nowin = dataclasses.replace(cfg, attn_impl="pallas", swa_window=None)
    c, _, _ = TT.forward(params, nowin, {"tokens": toks})
    assert not torch.equal(a, c)
    assert FK.launch_counts() == {"flash_attention": 0}


# ---------------------------------------------------------------------------
# fault 10: the sliding-window ring after a long prompt
# ---------------------------------------------------------------------------

def _window_case(S, cache_len):
    """Reduced mixtral (window 16) at capacity factor 8 with
    ``tests/test_decode_consistency.py``'s inputs: tokens from
    ``jax.random.randint(PRNGKey(0), (2, S))``, next token 7.  Returns
    (port cfg, reference cfg, port params, reference params, tokens of
    S + 1)."""
    cfg, jcfg = _cfgs("mixtral-8x7b", capacity_factor=8.0)
    key = jax.random.PRNGKey(0)
    jp = JT.init_params(key, jcfg, tp=1)
    params = TT.params_from_numpy(jax.tree.map(np.array, jp), cfg)
    toks = np.asarray(jax.random.randint(key, (2, S), 0, cfg.vocab_size))
    toks = np.concatenate([toks, np.full((2, 1), 7, toks.dtype)], 1)
    return cfg, jcfg, params, jp, toks.astype(np.int32)


def _ref_decode_error(jcfg, jp, toks, cache_len):
    S = toks.shape[1] - 1
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])}, tp=1,
                       cache_len=cache_len)
    jd, _ = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, S:]), tp=1)
    jf, _, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, tp=1)
    return _rel(jd, jf[:, -1])


#: the reference's own relative error after the prompt (its ring keeps the
#: last window in order; its decode writes slot pos % window)
REF_WINDOW_ERRORS = {32: None, 33: 0.857, 36: None, 40: None}


@pytest.mark.parametrize("S", sorted(REF_WINDOW_ERRORS))
def test_sliding_window_prefill_keeps_the_ring_aligned(S):
    """Reduced mixtral, prompts of 32, 33, 36 and 40 tokens over a 16-token
    window (cache_len S + 4, so a 16-slot ring): the port's prefill and one
    decode step give ``forward``'s last logits on S + 1 tokens within
    0.05, and the prompt's last 16 positions sit at slots p % 16.  The
    reference's decode is off by 0.857 of the largest logit at S = 33 (and
    0.403 at 36, 0.486 at 40): its prefill keeps the last window in order,
    so position p sits in slot p - (S - 16), and its first decode step
    overwrites a position still inside the window."""
    cfg, jcfg, params, jp, toks = _window_case(S, S + 4)
    _, cache = TT.prefill(params, cfg, {"tokens": toks[:, :S]},
                          cache_len=S + 4)
    _, _, (k, _) = TT.forward(params, cfg, {"tokens": toks[:, :S]},
                              collect_kv=True)
    slots = np.arange(S - 16, S) % 16
    assert torch.equal(cache["k"][:, :, slots], k[:, :, S - 16:])
    got, cache = TT.decode_step(params, cfg, cache, toks[:, S:])
    full, _, _ = TT.forward(params, cfg, {"tokens": toks})
    assert _rel(got, full[:, -1].float().numpy()) < LOGITS_REL
    ref_err = _ref_decode_error(jcfg, jp, toks, S + 4)
    if S % 16 == 0:
        assert ref_err < LOGITS_REL
    else:
        assert ref_err > 5 * LOGITS_REL
    if REF_WINDOW_ERRORS[S] is not None:
        assert abs(ref_err - REF_WINDOW_ERRORS[S]) < 0.01, ref_err


def test_a_full_ring_shorter_than_the_window_raises():
    """A 12-token prompt with no cache_len gives a 12-slot ring, shorter
    than the 16-token window: the reference's first decode step overwrites
    position 0, which the window still reads (0.601 of the largest logit
    off); the port's raises ``ValueError``.  With cache_len 16 both are
    right."""
    cfg, jcfg, params, jp, toks = _window_case(12, None)
    assert abs(_ref_decode_error(jcfg, jp, toks, None) - 0.601) < 0.01
    _, cache = TT.prefill(params, cfg, {"tokens": toks[:, :12]})
    assert cache["k"].shape[2] == 12
    with pytest.raises(ValueError, match="shorter than the 16-token window"):
        TT.decode_step(params, cfg, cache, toks[:, 12:])
    _, cache = TT.prefill(params, cfg, {"tokens": toks[:, :12]},
                          cache_len=16)
    got, _ = TT.decode_step(params, cfg, cache, toks[:, 12:])
    full, _, _ = TT.forward(params, cfg, {"tokens": toks})
    assert _rel(got, full[:, -1].float().numpy()) < LOGITS_REL
    assert _ref_decode_error(jcfg, jp, toks, 16) < LOGITS_REL


# ---------------------------------------------------------------------------
# training, engine and CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step (AdamW 3e-4, clip 1.0) from the
    reference's float32 init on 4 x 32 tokens: loss (cross-entropy plus
    0.01 aux) within 1e-3 and grad norm within 5e-3 relative of the
    reference's; the aux's gradient reaches the routers."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg, dtype=torch.float32)
    raw = {"tokens": _tokens(8, (4, 32)), "labels": _tokens(8, (4, 32))}
    jstep, jopt = JA.make_train_step(jcfg, 1)
    _, _, jm = _strict(jstep, jp, jopt.init(jp),
                       {k: jnp.asarray(v) for k, v in raw.items()})
    step, opt = TA.make_train_step(cfg)
    router0 = params["layers"][0]["moe"]["router"].clone()
    _, _, m = step(params, opt.init(params), raw)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-3 * float(jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        5e-3 * float(jm["grad_norm"])
    assert not torch.equal(params["layers"][0]["moe"]["router"], router0)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_serve_cli_on_the_cpu(arch):
    """``ServingEngine(arch, reduced=True, device="cpu")`` generates the
    model's own greedy tokens on its params (mixtral with a prompt longer
    than its window, so the ring wraps), with the reference's
    ``lm-generate`` report; ``launch.serve --reduced --device cpu`` prints
    one JSON line of the arch's tokens."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine
    prompt = 20 if arch == "mixtral-8x7b" else 8
    eng = ServingEngine(arch, reduced=True, device="cpu", prompt_len=prompt,
                        gen=3, seed=1)
    req = eng.make_request(2, seed=5)
    eng.submit(req)
    done = eng.drain()
    np.testing.assert_array_equal(done[0].result["tokens"],
                                  _greedy(eng.params, eng.cfg,
                                          req["tokens"], 3))
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


def test_train_cli_trains_a_moe_arch_on_the_cpu(capsys):
    """``launch.train --arch granite-moe-3b-a800m --reduced --steps 2
    --device cpu``: the reference's LM report keys, finite losses."""
    from repro_torch.launch import train
    assert train.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                       "--steps", "2", "--seq", "16", "--device",
                       "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rep["arch"], rep["steps"], rep["device"]) == \
        ("granite-moe-3b-a800m-reduced", 2, "cpu")
    assert np.isfinite(rep["first_loss"]) and np.isfinite(rep["last_loss"])
