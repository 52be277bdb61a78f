"""The LM families laid out at tp > 1 on one device, port against the
reference on the CPU: reduced dense qwen3-8b, MoE granite-moe-3b-a800m,
VLM llava-next-34b, SSM mamba2-1.3b, hybrid recurrentgemma-2b and
encoder-decoder whisper-large-v3 (2 layers, 3 for the hybrid; d_model
64, 4 query heads of 16 over 2 KV heads, 1 for the hybrid, 4 for
whisper; vocab 251, padded to 256 at every tp here).

At tp each model's params and caches take the reference's head layout
(``layers.make_head_layout``): dead query heads pad the query heads, KV
heads are repeated or padded with zero heads, and the vocabulary is
padded to ``cfg.vocab_padded(tp)``.  Nothing is sharded: this is the
reference's arithmetic at tp on one device.  The reference's params
(``init_params(PRNGKey(0), cfg, tp)``) are carried across as numpy, and
its model functions are compiled with ``xla_allow_excess_precision`` off
(as in ``tests/test_torch_lm_families.py``).  Bar: logits within 0.05 of
the largest reference logit (``tests/test_torch_lm.py``'s gate); the
loss within 1e-4 relative; cache shapes exact.

The cases: each family at tp 2 and 4; qwen3-8b at tp 3, where 2 KV heads
neither divide nor are divided by tp (the reference's awkward regime: KV
kept whole, query heads padded from 4 to 6); whisper at tp 3, its 4 MHA
heads padded to 6 with zero KV heads; recurrentgemma at tp 3, its one
KV head repeated 3 times and its 4 query heads padded to 6.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ARCHS = ("qwen3-8b", "granite-moe-3b-a800m", "llava-next-34b",
         "mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3")
CASES = ([(a, tp) for a in ARCHS for tp in (2, 4)]
         + [("qwen3-8b", 3), ("whisper-large-v3", 3),
            ("recurrentgemma-2b", 3)])
LOGITS_REL = 0.05
LOSS_REL = 1e-4
STRICT = {"xla_allow_excess_precision": False}
B, S, STEPS = 2, 16, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(port, reference) reduced configs; the hybrid's window 8 and the
    prompt of 16 keep the reference's ring aligned (its fault 11)."""
    return get_arch(arch).reduced(), jget_arch(arch).reduced()


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, tp):
    """The reference's init (PRNGKey(0)) of the reduced ``arch`` at
    ``tp``, as numpy."""
    _, jcfg = _cfgs(arch)
    init = jax.jit(lambda k: JA.module_for(jcfg).init_params(k, jcfg, tp=tp))
    return jax.tree.map(np.array, init(jax.random.PRNGKey(0)))


def _params(arch, cfg, tp):
    tree = _ref_tree(arch, tp)
    return (TA.module_for(cfg).params_from_numpy(tree, cfg),
            jax.tree.map(jnp.asarray, tree))


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


def _shapes(tree, prefix=()):
    """{path: shape} of a param tree, the port's list of layers and the
    reference's stacked leading axis both as the layer count first."""
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


@pytest.mark.parametrize("arch,tp", CASES)
def test_model_at_tp_matches_reference(arch, tp):
    """At ``tp``: the params have the reference's leaf shapes (query
    heads and vocabulary padded); ``forward``'s logits and ``loss_fn``
    against the reference's; prefill's last logits and its cache (every
    leaf's shape, the KV heads at the layout's ``kv_padded``); then two
    decode steps fed the same tokens in both packages, each step's logits
    against the reference's."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(arch, cfg, tp)
    mine = TA.module_for(cfg).init_params(cfg, tp=tp, device="meta")
    want = jax.eval_shape(lambda k: JA.module_for(jcfg).init_params(
        k, jcfg, tp=tp), jax.random.PRNGKey(0))
    assert _shapes(mine) == _shapes(want)
    assert mine["embed"]["table"].shape[0] == cfg.vocab_padded(tp)
    mod, jmod = TA.module_for(cfg), JA.module_for(jcfg)
    batch = _batch(cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    prompt = {k: v for k, v in batch.items() if k != "labels"}

    def ref(p, b):
        pre = {k: v for k, v in b.items() if k != "labels"}
        return (jmod.forward(p, jcfg, b, tp=tp)[0],
                jmod.loss_fn(p, jcfg, b, tp=tp),
                jmod.prefill(p, jcfg, pre, tp=tp, cache_len=S + STEPS))
    jl, jloss, (jlg, jcache) = _strict(ref, jp, jb)(jp, jb)
    logits = mod.forward(params, cfg, batch, tp=tp)[0]
    assert logits.shape == jl.shape
    assert _rel(logits, jl) < LOGITS_REL, _rel(logits, jl)
    loss = float(mod.loss_fn(params, cfg, batch, tp=tp))
    assert abs(loss - float(jloss)) <= LOSS_REL * float(jloss)

    lg, cache = TA.make_prefill(cfg, tp=tp, cache_len=S + STEPS)(params,
                                                                prompt)
    assert _rel(lg, jlg) < LOGITS_REL, _rel(lg, jlg)
    assert set(cache) == set(jcache)
    for k, v in jcache.items():
        got = tuple(cache[k].shape) if torch.is_tensor(cache[k]) else ()
        assert got == tuple(v.shape), k
    if "k" in cache:
        layout = TL.make_head_layout(cfg.num_heads, cfg.num_kv_heads, tp)
        assert cache["k"].shape[3] == layout.kv_padded
    feed = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    jdecode = _strict(lambda p, c, t: jmod.decode_step(p, jcfg, c, t, tp=tp),
                      jp, jcache, feed[0])
    decode = TA.make_decode_step(cfg, tp=tp)
    for t in range(STEPS):
        lg, cache = decode(params, cache, {"tokens": feed[t]})
        jlg, jcache = jdecode(jp, jcache, feed[t])
        assert _rel(lg, jlg) < LOGITS_REL, (t, _rel(lg, jlg))


@pytest.mark.parametrize("arch,tp,regime", [
    ("qwen3-8b", 2, "kv divisible by tp"), ("qwen3-8b", 4, "kv repeated"),
    ("qwen3-8b", 3, "awkward"), ("whisper-large-v3", 3, "MHA padded"),
    ("recurrentgemma-2b", 3, "kv repeated")])
def test_cases_cover_each_layout_regime(arch, tp, regime):
    """Exact: the layouts the cases above run, equal to the reference's,
    and in the regime each claims (the awkward one: kv neither divides
    nor is divided by tp, so KV stays whole and query heads are padded
    to a multiple of tp, dead slots in every group)."""
    cfg, _ = _cfgs(arch)
    q, kv = cfg.num_heads, cfg.num_kv_heads
    got = TL.make_head_layout(q, kv, tp)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JL.make_head_layout(q, kv, tp))
    if regime == "kv divisible by tp":
        assert kv % tp == 0 and got.kv_repeat == 1 and got.q_padded == q
    elif regime == "kv repeated":
        assert tp % kv == 0 and got.kv_padded == tp and got.kv_repeat > 1
    elif regime == "awkward":
        assert kv % tp and tp % kv
        assert got.kv_padded == kv and got.q_padded == 6 and got.slots == 3
    else:
        assert q == kv and got.q_padded == got.kv_padded == 6


def test_logits_at_tp4_equal_tp1():
    """One set of params (the reference's tp = 1 init of the reduced
    qwen3-8b; at tp 4 its leaves keep their shapes, since 4 query heads
    over 2 KV heads need no dead head and the 2 KV heads are repeated as
    activations): ``forward``, prefill and a decode step at tp 4 give the
    tp = 1 logits within the gate, as the reference's do."""
    cfg, jcfg = _cfgs("qwen3-8b")
    params, jp = _params("qwen3-8b", cfg, 1)
    assert (jax.tree.map(np.shape, _ref_tree("qwen3-8b", 4))
            == jax.tree.map(np.shape, _ref_tree("qwen3-8b", 1)))
    batch = {"tokens": _batch(cfg, 5)["tokens"]}
    one = TA.module_for(cfg).forward(params, cfg, batch, tp=1)[0]
    four = TA.module_for(cfg).forward(params, cfg, batch, tp=4)[0]
    assert _rel(four, one.float().numpy()) < LOGITS_REL
    jfour = _strict(lambda p, b: JA.module_for(jcfg).forward(
        p, jcfg, b, tp=4)[0], jp, {"tokens": jnp.asarray(batch["tokens"])})
    assert _rel(four, jfour(jp, {"tokens": jnp.asarray(batch["tokens"])})) \
        < LOGITS_REL
    caches = []
    for tp in (1, 4):
        lg, cache = TA.make_prefill(cfg, tp=tp, cache_len=S + 1)(params,
                                                                 batch)
        lg2, cache = TA.make_decode_step(cfg, tp=tp)(
            params, cache, {"tokens": batch["tokens"][:, :1]})
        caches.append((lg, lg2, cache))
    (a, a2, ca), (b, b2, cb) = caches
    assert ca["k"].shape[3] == 2 and cb["k"].shape[3] == 4
    assert torch.equal(cb["k"][:, :, :, ::2], ca["k"])
    assert _rel(b, a.float().numpy()) < LOGITS_REL
    assert _rel(b2, a2.float().numpy()) < LOGITS_REL


def test_params_laid_out_at_another_tp_raise():
    """Whisper's reduced params made at tp 3 (query heads padded to 6)
    run at tp 1 (a layout of 4) raise ``ValueError`` naming both counts,
    not a shape error deep in the attention."""
    cfg, _ = _cfgs("whisper-large-v3")
    params, _ = _params("whisper-large-v3", cfg, 3)
    batch = _batch(cfg, 1)
    with pytest.raises(ValueError, match="6 query heads.*wants 4"):
        TA.module_for(cfg).forward(params, cfg, batch, tp=1)
