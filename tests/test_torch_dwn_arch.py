"""Port vs reference: the DWN behind the model zoo's interface
(``models/dwn_arch.py`` through ``models/api.py``).

The reference's params (``init_params(PRNGKey(s), cfg, tp=1)``) are
carried across with ``params_from_numpy``; features come from a numpy
seed.  Prefill counts are compared exactly, the loss within 1e-6, its
gradients within 1e-5 of each leaf's largest, and three train steps
(loss, params, thresholds included) within 1e-5."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import dwn_arch as JD  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.models import dwn_arch as TD  # noqa: E402
from repro_torch.optim.grad import value_and_grad  # noqa: E402

LOSS_TOL = 1e-6
GRAD_REL = 1e-5
STEP_TOL = 1e-5

#: sm-10 and sm-50 at full width, and a small md-like model (120 LUTs over
#: 16 x 32 bits)
ARCHS = ("dwn-jsc-sm10", "dwn-jsc-sm50", "md-like")
VARIANTS = [(dp, grp, fused) for dp in ("corner", "gather")
            for grp in ("contig", "strided") for fused in (False, True)]


def _cfgs(arch, **kw):
    if arch == "md-like":
        kw = dict(dict(name="dwn-md-like", dwn_luts=120, dwn_bits=32), **kw)
        arch = "dwn-jsc-md360"
    return (dataclasses.replace(get_arch(arch), **kw),
            dataclasses.replace(jget_arch(arch), **kw))


def _params(jcfg, seed=0):
    ref = JD.init_params(jax.random.PRNGKey(seed), jcfg, tp=1)
    return ref, TD.params_from_numpy(jax.tree.map(np.asarray, ref))


def _features(B, F=16, seed=1):
    # the threshold grid spans [-1, 1]: most features land inside it
    return np.random.default_rng(seed).standard_normal(
        (B, F)).astype(np.float32) * 0.7


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_grid_and_axes_match_reference(arch):
    """Exact shapes, dtypes and logical axes; the threshold grid within
    one float32 ulp of ``jnp.linspace``'s (XLA rounds a few entries the
    other way), tables in [-1, 1), scores ~ 0.01 N(0, 1)."""
    cfg, jcfg = _cfgs(arch)
    ref = JD.init_params(jax.random.PRNGKey(0), jcfg, tp=1)
    got = TD.init_params(torch.Generator().manual_seed(0), cfg)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == {
        k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in ref.items()}
    np.testing.assert_allclose(got["thresholds"].numpy(),
                               np.asarray(ref["thresholds"]), rtol=0,
                               atol=1.2e-7)
    assert got["tables"].min() >= -1 and got["tables"].max() < 1
    assert abs(float(got["scores"].std()) - 0.01) < 2e-3
    meta = TD.init_params(torch.Generator(), cfg, device="meta")
    assert all(v.is_meta for v in meta.values())
    assert {k: tuple(v) for k, v in TD.param_axes(cfg).items()} == \
        {k: tuple(v) for k, v in JD.param_axes(jcfg).items()}
    assert {k: v.name for k, v in TD.param_axes(cfg).items()} == \
        {k: v.name for k, v in JD.param_axes(jcfg).items()}


@pytest.mark.parametrize("B", [64, 37])
@pytest.mark.parametrize("dp,grp,fused", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_counts_equal_reference(arch, dp, grp, fused, B):
    """Exact: counts of every datapath x grouping x fused variant equal
    the reference's, on a batch 16 divides (the fused variant's 16
    blocks) and one it does not (one block); corner equals gather."""
    cfg, jcfg = _cfgs(arch, dwn_datapath=dp, dwn_grouping=grp,
                      dwn_fused=fused)
    ref_p, params = _params(jcfg)
    x = _features(B)
    want, jcache = JD.prefill(ref_p, jcfg, {"features": jnp.asarray(x)},
                              tp=1)
    got, cache = TA.make_prefill(cfg)(params,
                                      {"features": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 0
    other = dataclasses.replace(
        cfg, dwn_datapath="gather" if dp == "corner" else "corner")
    np.testing.assert_array_equal(
        TD.prefill(params, other, {"features": torch.from_numpy(x)})[0],
        got.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """The loss within 1e-6 and every gradient within 1e-5 of its leaf's
    largest; the thresholds take a zero gradient in both."""
    cfg, jcfg = _cfgs(arch)
    ref_p, params = _params(jcfg, seed=3)
    x = _features(96, seed=4)
    y = np.random.default_rng(5).integers(0, 5, 96).astype(np.int32)
    jl, jg = jax.value_and_grad(
        lambda p: JD.loss_fn(p, jcfg, {"features": jnp.asarray(x),
                                       "labels": jnp.asarray(y)}, tp=1))(
        ref_p)
    (tl, _), tg = value_and_grad(
        lambda p, b: (TD.loss_fn(p, cfg, b), None), params,
        {"features": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    for k in ("scores", "tables", "thresholds"):
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(tg[k].numpy(), want, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=k)
    assert not tg["thresholds"].any()


@pytest.mark.parametrize("num_micro", [1, 2])
@pytest.mark.parametrize("arch", ["dwn-jsc-sm50", "md-like"])
def test_three_train_steps_match_reference(arch, num_micro):
    """Three ``make_train_step`` steps (AdamW, weight decay 0.1, global
    clip 1.0) equal the reference's at tp = 1 within 1e-5: losses, grad
    norms and every param, the thresholds included, which the weight
    decay moves although their gradient is zero."""
    cfg, jcfg = _cfgs(arch)
    ref_p, params = _params(jcfg, seed=6)
    th0 = params["thresholds"].clone()
    jstep, jopt = JA.make_train_step(jcfg, tp=1, num_micro=num_micro)
    tstep, topt = TA.make_train_step(cfg, num_micro=num_micro)
    jstate, tstate = jopt.init(ref_p), topt.init(params)
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = _features(64, seed=int(rng.integers(1 << 30)))
        y = rng.integers(0, 5, 64).astype(np.int32)
        if num_micro > 1:
            x = x.reshape(num_micro, -1, 16)
            y = y.reshape(num_micro, -1)
        ref_p, jstate, jm = jstep(ref_p, jstate, {
            "features": jnp.asarray(x), "labels": jnp.asarray(y)})
        params, tstate, tm = tstep(params, tstate, {
            "features": torch.from_numpy(x), "labels": torch.from_numpy(y)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) < STEP_TOL
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            < STEP_TOL
    for k in ("scores", "tables", "thresholds"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=0, atol=STEP_TOL, err_msg=k)
    # decayed: (1 - lr * 0.1) per step, the thresholds' only update
    moved = (params["thresholds"] - th0).abs().max()
    assert 1e-5 < float(moved) < 1e-4


def test_decode_raises_and_cache_matches_reference():
    """``decode_step`` raises the reference's error; ``init_cache`` and
    ``cache_axes`` equal the reference's."""
    cfg, jcfg = _cfgs("dwn-jsc-sm50")
    with pytest.raises(NotImplementedError,
                       match="feed-forward classifier; serving = batched "
                             "prefill"):
        TA.make_decode_step(cfg)({}, {}, {"tokens": None})
    with pytest.raises(NotImplementedError, match="feed-forward"):
        JD.decode_step({}, jcfg, {}, None)
    ref = JD.init_cache(jcfg, 8, 16, tp=1)
    got = TD.init_cache(cfg, 8, 16)
    assert set(got) == set(ref) == {"pos"}
    assert tuple(got["pos"].shape) == ref["pos"].shape == ()
    assert str(got["pos"].dtype) == "torch." + str(ref["pos"].dtype)
    for seq_shard in (False, True):
        g = TD.cache_axes(cfg, seq_shard=seq_shard)
        r = JD.cache_axes(jcfg, seq_shard=seq_shard)
        assert {k: (tuple(v), v.name) for k, v in g.items()} == \
            {k: (tuple(v), v.name) for k, v in r.items()}


def test_module_for_registered_dwn_archs():
    """Every registered DWN arch runs through ``dwn_arch``, as in the
    reference."""
    from repro_torch.configs import list_archs
    names = [n for n in list_archs() if get_arch(n).family == "dwn"]
    assert len(names) == 29
    for n in names:
        assert TA.module_for(get_arch(n)) is TD
        assert JA.module_for(jget_arch(n)) is JD


@pytest.mark.parametrize("arch", ["dwn-jsc-lg2400-opt3", "dwn-jsc-sm50-pruned",
                                  "dwn-jsc-md360-pruned", "md-like"])
@pytest.mark.parametrize("grp", ["contig", "strided"])
def test_prefill_equals_the_served_artifact(arch, grp):
    """Exact: ``dwn_arch.artifact`` freezes the same model (first argmax
    wiring, tables > 0, the thresholds, strided groups reordered into
    contiguous ones) and its served counts (the fused-packed backend:
    K2's plain version on the CPU) and ``apply_hard`` equal prefill's."""
    from repro_torch.core.model import apply_hard
    from repro_torch.serving.backends import BoundBackend, get_backend
    cfg, jcfg = _cfgs(arch, dwn_grouping=grp)
    if arch == "md-like":
        cfg = dataclasses.replace(cfg, dwn_luts=360, dwn_bits=12)
    params = TD.init_params(torch.Generator().manual_seed(2), cfg)
    x = torch.from_numpy(_features(96, seed=9))
    want = TD.prefill(params, cfg, {"features": x})[0]
    art = TD.artifact(params, cfg).pack("cpu")
    assert art.spec.grouping == grp and art.spec.bits == cfg.dwn_bits
    counts, pred = BoundBackend(get_backend("fused-packed"),
                                art.serving_model())(x)
    np.testing.assert_array_equal(counts.numpy(), want.numpy())
    np.testing.assert_array_equal(apply_hard(art.frozen, x).numpy(),
                                  want.numpy())
    np.testing.assert_array_equal(
        pred.numpy(), torch.argmax(want, -1).to(torch.int32).numpy())


def test_engine_serves_a_dwn_arch_config_as_its_spec():
    """A DWN ``ArchConfig`` given to ``ServingEngine`` serves as the spec
    ``resolve_spec`` derives from it (the reference's bridge), bit-exact
    against the oracle, alone without a process group."""
    from repro_torch.dwn import resolve_spec
    from repro_torch.serving import ServingEngine
    cfg = get_arch("dwn-jsc-lg2400-opt2")
    spec = resolve_spec(cfg)
    assert (spec.preset, spec.grouping, spec.datapath) == (
        "lg-2400", "strided", "fused-packed")
    eng = ServingEngine(dataclasses.replace(cfg, dwn_luts=50), device="cpu",
                        max_bucket=32, n_train=300)
    eng.submit(eng.make_request(20, seed=1))
    (done,) = eng.drain()
    rep = eng.report()
    assert rep["arch"] == "dwn-jsc-lg2400-opt2" and rep["luts"] == 50
    assert (rep["data_parallel"], rep["devices"]) == (False, 1)
    assert all(rep["bit_exact_vs_oracle"].values())
    assert done.result[0].shape == (20, 5)
