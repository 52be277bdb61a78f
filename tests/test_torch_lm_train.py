"""LM training in the port against the reference on the CPU: the token
stream, gradient processing, the cross-entropy, ``loss_fn`` and its
gradients, ``make_train_step``, checkpoints of an LM train state, the
``Supervisor`` restart and the train CLI's LM branch.

The reduced qwen3-8b (2 layers, d_model 64, vocab 251) starts from the
reference's init carried across as numpy (``params_from_numpy(...,
dtype=torch.float32)``, the reference's float32 master weights).  Bars:

* ``TokenStream``, ``topk_compress`` and checkpoint paths: exact.
* ``global_norm``, clipping and accumulation: float32 sums in another
  order, within 1e-6 relative.
* ``cross_entropy_loss`` on bf16 logits: within 1e-6 relative, its
  gradient within 1e-6 of the largest.
* The model's loss and gradients: the reference is compiled with
  ``xla_allow_excess_precision`` off, so that it rounds every bf16
  intermediate as the port does (with XLA's default it keeps some in
  float32: its loss then moves by 2.6e-4 and its gradients by about 1.5 %
  in norm).  Loss within 1e-5 relative; each leaf's gradient within 2e-2
  in norm and 5e-2 of its largest value (bf16 products summed in another
  order round differently).
* Three train steps: loss within 1e-3 and grad norm within 5e-3 relative
  a step; every parameter within 3 * lr * steps of the reference's (Adam
  moves an element by at most about 1.2 lr a step, so a gradient that is
  rounding noise, and whose sign differs, separates the two by up to
  twice that); each leaf's update but the embedding table's within 1e-1
  in norm (such elements move it by up to 7 % here).
"""

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
from repro.data.tokens import TokenStream as JStream  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import grad as JG  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import grad as TG  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return dataclasses.replace(get_arch("qwen3-8b").reduced(), **kw)


def _jcfg(**kw):
    return dataclasses.replace(jget_arch("qwen3-8b").reduced(), **kw)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's init (tp = 1) as jax arrays and as numpy."""
    jp = JT.init_params(jax.random.PRNGKey(0), _jcfg(), tp=1)
    return jp, jax.tree.map(np.asarray, jp)


def _port_params(np_tree):
    return TT.params_from_numpy(np_tree, _cfg(), dtype=torch.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pairs(jtree, ttree, num_layers):
    """(name, reference leaf, port leaf) of every leaf, the reference's
    stacked layers split per layer."""
    out = []
    for kp, a in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [k.key for k in kp]
        if keys[0] == "layers":
            for i in range(num_layers):
                node = ttree["layers"][i]
                for k in keys[1:]:
                    node = node[k]
                out.append((f"{jax.tree_util.keystr(kp)}[{i}]",
                            np.asarray(a[i], np.float32), node))
        else:
            node = ttree
            for k in keys:
                node = node[k]
            out.append((jax.tree_util.keystr(kp),
                        np.asarray(a, np.float32), node))
    return out


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,gb,seed,hosts", [
    (251, 32, 4, 0, 1), (151936, 16, 6, 3, 2), (5000, 8, 8, 7, 4)])
def test_token_stream_copy_is_bit_exact(vocab, seq, gb, seed, hosts):
    """Exact: every host's batches, step by step; the state, a restore
    and a skip-ahead give the reference's batches."""
    for host in range(hosts):
        mine = TokenStream(vocab, seq, gb, seed=seed, num_hosts=hosts,
                           host_id=host)
        ref = JStream(vocab, seq, gb, seed=seed, num_hosts=hosts,
                      host_id=host)
        for _ in range(3):
            a, b = mine.next_batch(), ref.next_batch()
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            assert a["tokens"].shape == (gb // hosts, seq)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
        assert mine.state() == ref.state() == {"step": 3}
        mine.restore({"step": 1})
        ref.restore({"step": 1})
        np.testing.assert_array_equal(mine.next_batch()["tokens"],
                                      ref.next_batch()["tokens"])
        mine.restore({"step": 40})                   # skip-ahead
        ref.restore({"step": 40})
        np.testing.assert_array_equal(mine.next_batch()["tokens"],
                                      ref.next_batch()["tokens"])
    with pytest.raises(AssertionError):
        TokenStream(vocab, seq, 5, num_hosts=2)


# ---------------------------------------------------------------------------
# optim/grad.py
# ---------------------------------------------------------------------------

def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return {"a": f(7, 5), "layers": [{"w": f(3, 4)}, {"w": f(3, 4)}],
            "z": f(11)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    """Within 1e-6 relative: the norm and the clipped leaves, below and
    above the bar; the in-place clip equals the returned one."""
    tree = _np_tree(0, 0.3)
    jc, jn = JG.clip_by_global_norm(_to_jax(tree), max_norm)
    tt = _to_torch(tree)
    tc, tn = TG.clip_by_global_norm(tt, max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert abs(float(TG.global_norm(tt)) - float(JG.global_norm(
        _to_jax(tree)))) <= 1e-6 * float(jn)
    for a, b in zip(jax.tree.leaves(jc), leaves(tc)):
        assert _rel(b, a) < 1e-6
    inplace, n2 = TG.clip_by_global_norm(tt, max_norm, in_place=True)
    assert inplace is tt and float(n2) == float(tn)
    for a, b in zip(leaves(tc), leaves(tt)):
        assert torch.equal(a, b)


def _linear_loss_j(params, micro):
    y = micro["x"] @ params["a"] + params["layers"][0]["w"].sum()
    return jnp.mean((y - micro["y"]) ** 2) + jnp.sum(params["z"] ** 2), None


def _linear_loss_t(params, micro):
    x, yt = (torch.as_tensor(micro[k]) for k in ("x", "y"))
    y = x @ params["a"] + params["layers"][0]["w"].sum()
    return torch.mean((y - yt) ** 2) + torch.sum(params["z"] ** 2), None


@pytest.mark.parametrize("num_micro", [1, 2, 3])
def test_accumulate_grads_matches_reference(num_micro):
    """Within 1e-6 of each leaf's largest: the mean loss and gradients
    over microbatches (a leaf the loss does not reach gets zeros)."""
    rng = np.random.default_rng(5)
    params = _np_tree(1, 0.5)
    batches = {"x": rng.standard_normal((num_micro, 6, 7)).astype(np.float32),
               "y": rng.standard_normal((num_micro, 6, 5)).astype(np.float32)}
    jl, jg = JG.accumulate_grads(_linear_loss_j, _to_jax(params),
                                 _to_jax(batches), num_micro)
    tl, tg = TG.accumulate_grads(_linear_loss_t, _to_torch(params), batches,
                                 num_micro)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    for a, b in zip(jax.tree.leaves(jg), leaves(tg)):
        a = np.asarray(a)
        if not np.abs(a).max():
            assert not b.abs().max()
            continue
        assert _rel(b, a) < 1e-6


def test_topk_compress_matches_reference_exactly():
    """Exact over two steps of error feedback: the same support (ties at
    the k-th magnitude included), the same sent values and residuals."""
    grads = _np_tree(2)
    grads["z"][:6] = 1.5                       # a tie at the threshold
    jstate = JG.topk_compress_init(_to_jax(grads))
    tstate = TG.topk_compress_init(_to_torch(grads))
    for step in range(2):
        g = _np_tree(10 + step) if step else grads
        js, jstate = JG.topk_compress(_to_jax(g), jstate, k_frac=0.2)
        ts, tstate = TG.topk_compress(_to_torch(g), tstate, k_frac=0.2)
        for a, b in zip(jax.tree.leaves(js), leaves(ts)):
            np.testing.assert_array_equal(np.asarray(a) != 0, b.numpy() != 0)
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jax.tree.leaves(jstate.error), leaves(tstate.error)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int((ts["z"] != 0).sum()) >= 2


# ---------------------------------------------------------------------------
# cross-entropy and the model's loss
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    """Padded vocabulary masked, z-loss 1e-4, labels of -1 ignored; bf16
    logits: the loss within 1e-6 relative and its gradient within 1e-6
    of the largest; all labels ignored gives 0."""
    rng = np.random.default_rng(3)
    lg = (rng.standard_normal((3, 9, 40)) * 4).astype(np.float32)
    lab = rng.integers(0, 37, (3, 9)).astype(np.int32)
    lab[0, :4] = -1
    lab[2, 8] = -1
    jlog = jnp.asarray(lg).astype(jnp.bfloat16)
    want, jgrad = jax.value_and_grad(
        lambda x: JL.cross_entropy_loss(x.astype(jnp.bfloat16),
                                        jnp.asarray(lab), vocab_real=37))(
        jnp.asarray(jlog, jnp.float32))
    x = torch.tensor(np.asarray(jlog, np.float32), requires_grad=True)
    got = TL.cross_entropy_loss(x.to(torch.bfloat16), torch.from_numpy(lab),
                                vocab_real=37)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * float(want)
    assert _rel(x.grad.numpy(), jgrad) < 1e-6
    none = TL.cross_entropy_loss(x, torch.full((3, 9), -1), vocab_real=37)
    assert float(none) == 0.0


def _ref_value_and_grad(jp, cfg, batch):
    fn = jax.value_and_grad(lambda p, b: JT.loss_fn(p, cfg, b, tp=1))
    return jax.jit(fn).lower(jp, batch).compile(compiler_options=STRICT)(
        jp, batch)


@pytest.mark.slow
def test_loss_fn_and_gradients_match_reference(ref_params):
    """The reduced qwen3-8b's next-token loss and every leaf's gradient
    against the reference's (bars in the module docstring); the layers
    recomputed in the backward pass (``remat``) give the same gradients
    bit for bit as kept activations."""
    jp, np_tree = ref_params
    toks = np.random.default_rng(0).integers(0, 251, (4, 32)).astype(
        np.int32)
    toks[1, 5:9] = 250
    labels = toks.copy()
    labels[0, 10:14] = -1
    batch = {"tokens": toks, "labels": labels}
    want, jg = _ref_value_and_grad(jp, _jcfg(), _to_jax(batch))
    grads = {}
    for remat in (True, False):
        cfg = _cfg(remat=remat)
        (loss, _), g = TG.value_and_grad(
            lambda p, b: (TT.loss_fn(p, cfg, b), None),
            _port_params(np_tree), batch)
        assert abs(float(loss) - float(want)) <= 1e-5 * float(want)
        grads[remat] = g
    for a, b in zip(leaves(grads[True]), leaves(grads[False])):
        assert torch.equal(a, b)
    for name, a, b in _pairs(jg, grads[True], 2):
        assert b.dtype == torch.float32, name
        b = b.numpy()
        norm = float(np.linalg.norm(a - b) / np.linalg.norm(a))
        assert norm < 2e-2, (name, norm)
        assert _rel(b, a) < 5e-2, (name, _rel(b, a))


@pytest.mark.slow
def test_training_under_pallas_attention_raises_as_the_reference_does(
        ref_params):
    """K10 has no backward.  ``jax.grad`` of the reference's ``loss_fn``
    under ``attn_impl="pallas"`` fails (an ``AssertionError`` in Pallas's
    JVP rule); the port raises ``NotImplementedError`` naming the missing
    backward instead of differentiating the plain attention in its
    place.  Serving under ``"pallas"`` (no gradients) still runs."""
    jp, np_tree = ref_params
    toks = np.random.default_rng(1).integers(0, 251, (2, 16)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(Exception):
        jax.value_and_grad(lambda p: JT.loss_fn(
            p, _jcfg(attn_impl="pallas"), _to_jax(batch), tp=1))(jp)
    cfg = _cfg(attn_impl="pallas")
    params = _port_params(np_tree)
    with pytest.raises(NotImplementedError, match="no backward"):
        TG.value_and_grad(lambda p, b: (TT.loss_fn(p, cfg, b), None),
                          params, batch)
    with torch.no_grad():
        assert torch.isfinite(TT.loss_fn(params, cfg, batch))


@pytest.mark.slow
@pytest.mark.parametrize("num_micro", [1, 2])
def test_train_step_matches_reference(ref_params, num_micro):
    """Three steps of ``make_train_step`` (AdamW lr 3e-4, b 0.9/0.95, wd
    0.1, clip 1.0) on ``TokenStream`` batches against the reference's
    step from the same init; bars in the module docstring."""
    jp, np_tree = ref_params
    steps, lr = 3, 3e-4
    jstep, jopt = JA.make_train_step(_jcfg(), 1, num_micro=num_micro)
    tstep, topt = TA.make_train_step(_cfg(), num_micro=num_micro)
    assert (topt.lr, topt.b1, topt.b2, topt.weight_decay) == \
        (jopt.lr, jopt.b1, jopt.b2, jopt.weight_decay) == (lr, .9, .95, .1)
    params = _port_params(np_tree)
    tstate = topt.init(params)
    jstate = jopt.init(jp)
    jpp, compiled = jp, None
    stream = TokenStream(251, 32, 4, seed=0)
    for _ in range(steps):
        raw = stream.next_batch()
        if num_micro > 1:
            raw = {k: v.reshape(num_micro, -1, v.shape[-1])
                   for k, v in raw.items()}
        jb = _to_jax(raw)
        if compiled is None:
            compiled = jax.jit(jstep).lower(jpp, jstate, jb).compile(
                compiler_options=STRICT)
        jpp, jstate, jm = compiled(jpp, jstate, jb)
        out, tstate, tm = tstep(params, tstate, raw)
        assert out is params
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-3 * float(jm["loss"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            5e-3 * float(jm["grad_norm"])
    assert int(tstate.step) == int(jstate.step) == steps
    init = _port_params(np_tree)
    for (name, a, b), (_, a0, _) in zip(_pairs(jpp, params, 2),
                                        _pairs(jp, init, 2)):
        b = b.numpy()
        assert np.abs(a - b).max() <= 3 * lr * steps, name
        if "embed']['table" not in name:
            da, db = a - a0, b - a0
            assert np.linalg.norm(da - db) <= 1e-1 * np.linalg.norm(da), \
                name
    with pytest.raises(ValueError, match="float32"):
        tstep(TT.params_from_numpy(np_tree, _cfg()), tstate, raw)


# ---------------------------------------------------------------------------
# checkpoints, restart, CLI
# ---------------------------------------------------------------------------

def test_lm_train_state_checkpoints_on_the_reference_layout(tmp_path):
    """Exact: a (params with a list of layers, AdamState) tree has the
    reference's leaf paths (``1/.mu/...``); the port restores what the
    reference saved, and its own save, bit for bit."""
    from repro.optim.adam import AdamState as JState
    from repro.runtime import checkpoint as jck
    from repro_torch.optim.adam import AdamState
    from repro_torch.runtime import checkpoint as tck
    tree = _np_tree(4)
    jtree = (_to_jax(tree), JState(jnp.asarray(3, jnp.int32),
                                   _to_jax(_np_tree(5)),
                                   _to_jax(_np_tree(6))))
    ttree = (_to_torch(tree), AdamState(torch.tensor(3, dtype=torch.int32),
                                        _to_torch(_np_tree(5)),
                                        _to_torch(_np_tree(6))))
    assert [n for n, _ in tck._leaf_paths(ttree)] == \
        [n for n, _ in jck._leaf_paths(jtree)]
    jck.save(tmp_path / "ref", 7, jtree, extra={"data": {"step": 7}})
    tck.save(tmp_path / "port", 7, ttree, extra={"data": {"step": 7}})
    for d in ("ref", "port"):
        step, got, extra = tck.restore_latest(tmp_path / d, ttree)
        assert step == 7 and extra == {"data": {"step": 7}}
        assert isinstance(got[1], AdamState)
        for a, b in zip(tck._leaf_paths(got), tck._leaf_paths(ttree)):
            assert a[0] == b[0] and torch.equal(a[1], b[1])


def _cli(argv):
    from repro_torch.launch import train
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert train.main(argv) == 0
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines


#: the keys the reference's LM branch prints (src/repro/launch/train.py,
#: the closing ``json.dumps``); its CLI fails on this host (ROADMAP Queue
#: 3, fault 1: the host mesh's ShardingTypeError)
REF_LM_KEYS = {"arch", "steps", "first_loss", "last_loss",
               "straggler_events"}


@pytest.mark.slow
def test_lm_train_cli_on_the_cpu():
    """``--arch qwen3-8b --reduced --steps 4 --device cpu`` prints the
    reference's keys plus the device, the loss every ``--log-every``
    steps, and equals the same steps driven through ``make_train_step``
    from the port's init; ``--model-parallel 2`` without a process group
    trains at tp 1 on one device (the model axis cut to the world)."""
    rep, lines = _cli(["--arch", "qwen3-8b", "--reduced", "--steps", "4",
                       "--log-every", "2", "--device", "cpu"])
    assert set(rep) == REF_LM_KEYS | {"device", "model_parallel",
                                      "devices"}
    assert (rep["model_parallel"], rep["devices"]) == (1, 1)
    assert rep["arch"] == "qwen3-8b-reduced" and rep["steps"] == 4
    assert rep["device"] == "cpu" and rep["straggler_events"] == 0
    assert [ln.split()[1] for ln in lines[:-1]] == ["2", "4"]
    cfg = _cfg()
    step, opt = TA.make_train_step(cfg, opt=TA.make_optimizer(3e-4))
    params = TT.init_params(cfg, seed=0, dtype=torch.float32)
    state = opt.init(params)
    stream = TokenStream(251, 128, 8, seed=0)
    losses = [float(step(params, state, stream.next_batch())[2]["loss"])
              for _ in range(4)]
    assert rep["first_loss"] == losses[0]
    assert rep["last_loss"] == float(np.mean(losses))
    cut, _ = _cli(["--arch", "qwen3-8b", "--reduced", "--model-parallel",
                   "2", "--steps", "1", "--device", "cpu"])
    assert (cut["model_parallel"], cut["devices"]) == (1, 1)
    assert cut["first_loss"] == losses[0]


@pytest.mark.slow
@pytest.mark.parametrize("crash_at", [1, 3])
def test_lm_train_cli_crashed_and_resumed_equals_uninterrupted(
        tmp_path, monkeypatch, crash_at):
    """A ``--ckpt-dir`` run whose step crashes once (before the first
    checkpoint, or after the one at step 2) resumes and ends with the
    same params, Adam state and token-stream position, bit for bit, as
    an uninterrupted run; the port's in-place steps restart from a fresh
    init when no checkpoint exists."""
    from repro_torch.runtime import checkpoint as tck
    from repro_torch.runtime import fault
    argv = ["--arch", "qwen3-8b", "--reduced", "--steps", "5", "--seq",
            "16", "--batch", "2", "--save-every", "2", "--device", "cpu"]
    whole, _ = _cli(argv + ["--ckpt-dir", str(tmp_path / "whole")])

    make = TA.make_train_step
    injector = fault.FaultInjector({crash_at})
    monkeypatch.setattr(fault.time, "sleep", lambda s: None)

    def crashing(*a, **kw):
        step, opt = make(*a, **kw)

        def wrapped(params, state, batch):
            injector.maybe_crash(int(state.step) + 1)
            return step(params, state, batch)
        return wrapped, opt

    monkeypatch.setattr(TA, "make_train_step", crashing)
    crashed, _ = _cli(argv + ["--ckpt-dir", str(tmp_path / "crashed")])
    assert injector.fired == 1
    assert crashed["steps"] == whole["steps"] == 5
    assert crashed["first_loss"] == whole["first_loss"]
    a_step, b_step = (tck.latest_step(tmp_path / d)
                      for d in ("whole", "crashed"))
    assert a_step == b_step == 5
    base_a, base_b = (tmp_path / d / "step_00000005"
                      for d in ("whole", "crashed"))
    ma = json.loads((base_a / "manifest.json").read_text())
    mb = json.loads((base_b / "manifest.json").read_text())
    assert ma["extra"] == mb["extra"] == {"data": {"step": 5}}
    assert ma["leaves"].keys() == mb["leaves"].keys()
    assert any(k.startswith("1/.nu/layers/1/") for k in ma["leaves"])
    for name, meta in ma["leaves"].items():
        assert meta["sha256"] == mb["leaves"][name]["sha256"], name
