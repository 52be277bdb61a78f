"""Port vs reference: the frozen model (``core/model.py``).

The parameters are drawn with numpy from a seed (the reference's init
shapes and ranges) and cross to the port through ``params_from_numpy``.
Every comparison is exact: wires and tables are integers and counts are
integers held in float32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model as jm  # noqa: E402
from repro.data.jsc import load_jsc  # noqa: E402
from repro_torch.core import model as tm  # noqa: E402

ROWS = load_jsc(2000, 300, seed=1)
# ragged batch sizes, including one and a non-multiple of 8 or 32
SIZES = (1, 37)


def _numpy_params(cfg, seed):
    rng = np.random.default_rng(seed)
    layers = []
    for s in cfg.layer_specs():
        scores = rng.normal(0, 0.01, (s.num_luts, s.fan_in,
                                      s.num_candidates)).astype(np.float32)
        tables = rng.uniform(-1, 1, (s.num_luts, s.table_size))
        layers.append({"scores": scores, "tables": tables.astype(np.float32)})
    th = jm.fit_thresholds(ROWS.x_train, cfg.thermometer)
    return {"layers": layers}, {"thresholds": th}


def _both_frozen(jcfg, frac_bits, seed=0):
    params, buffers = _numpy_params(jcfg, seed)
    jfrozen = jm.freeze(jax.tree_util.tree_map(jnp.asarray, params),
                        {"thresholds": jnp.asarray(buffers["thresholds"])},
                        jcfg, input_frac_bits=frac_bits)
    tcfg = tm.DWNConfig(**dataclasses.asdict(jcfg))
    tparams, tbuffers = tm.params_from_numpy(params, buffers)
    tfrozen = tm.freeze(tparams, tbuffers, tcfg, input_frac_bits=frac_bits)
    return jfrozen, tfrozen


def _assert_same_frozen(jfrozen, tfrozen):
    assert tfrozen.thresholds.dtype == np.float32
    assert tfrozen.thresholds.tobytes() == \
        np.asarray(jfrozen.thresholds).tobytes()
    for a, b in zip(tfrozen.mapping_idx, jfrozen.mapping_idx):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    for a, b in zip(tfrozen.tables_bin, jfrozen.tables_bin):
        np.testing.assert_array_equal(a, b)


def _assert_same_counts(jfrozen, tfrozen):
    ref_fn = jax.jit(lambda x: (jm.apply_hard(jfrozen, x),
                                jm.apply_hard_packed(jfrozen, x)))
    for size in SIZES:
        x = ROWS.x_test[:size]
        ref, ref_p = (np.asarray(a) for a in ref_fn(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        got = tm.apply_hard(tfrozen, xt)
        got_p = tm.apply_hard_packed(tfrozen, xt)
        assert got.dtype == got_p.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got_p.numpy(), ref_p)


@pytest.mark.parametrize("preset", ["sm-10", "sm-50", "md-360"])
@pytest.mark.parametrize("frac_bits", [None, 8], ids=["TEN", "PEN9"])
def test_freeze_and_apply_hard_match_reference(preset, frac_bits):
    """Exact: identical frozen wires/tables/thresholds, and identical
    apply_hard and apply_hard_packed counts on ragged batches."""
    jfrozen, tfrozen = _both_frozen(jm.JSC_PRESETS[preset], frac_bits)
    _assert_same_frozen(jfrozen, tfrozen)
    _assert_same_counts(jfrozen, tfrozen)


def test_two_layer_stack_matches_reference():
    """Exact: a (120, 50) stack, TEN and PEN, frozen and applied."""
    jcfg = jm.DWNConfig(lut_counts=(120, 50))
    for frac_bits in (None, 8):
        jfrozen, tfrozen = _both_frozen(jcfg, frac_bits, seed=5)
        _assert_same_frozen(jfrozen, tfrozen)
        _assert_same_counts(jfrozen, tfrozen)


def test_frozen_from_reference_arrays_and_accuracy():
    """Exact: a FrozenDWN built straight from the reference's numpy arrays
    serves the same counts; streaming accuracies agree to the sample."""
    jfrozen, _ = _both_frozen(jm.JSC_PRESETS["sm-50"], None, seed=2)
    tfrozen = tm.FrozenDWN(
        tm.JSC_PRESETS["sm-50"], np.asarray(jfrozen.thresholds),
        [np.asarray(a) for a in jfrozen.mapping_idx],
        [np.asarray(a) for a in jfrozen.tables_bin])
    _assert_same_counts(jfrozen, tfrozen)
    x, y = ROWS.x_test, ROWS.y_test
    ref = jm.eval_accuracy_hard(jfrozen, x, y, batch=128)
    assert tm.eval_accuracy_hard(tfrozen, x, y, batch=128) == ref
    assert tm.eval_accuracy_hard_packed(tfrozen, x, y, batch=97) == ref


def test_eval_accuracy_defaults_to_the_frozen_models_device():
    """Exact: with no ``device`` the rows go where the frozen model lives —
    the CPU for numpy fields, the tensors' device for tensor fields — and
    the accuracy is the reference's either way."""
    jfrozen, _ = _both_frozen(jm.JSC_PRESETS["sm-50"], None, seed=2)
    arrays = (np.asarray(jfrozen.thresholds),
              [np.asarray(a) for a in jfrozen.mapping_idx],
              [np.asarray(a) for a in jfrozen.tables_bin])
    as_numpy = tm.FrozenDWN(tm.JSC_PRESETS["sm-50"], *arrays)
    as_tensors = tm.FrozenDWN(
        tm.JSC_PRESETS["sm-50"], torch.from_numpy(arrays[0]),
        [torch.from_numpy(a) for a in arrays[1]],
        [torch.from_numpy(a) for a in arrays[2]])
    assert tm.frozen_device(as_numpy) == torch.device("cpu")
    assert tm.frozen_device(as_tensors) == torch.device("cpu")
    meta = tm.FrozenDWN(tm.JSC_PRESETS["sm-50"],
                        torch.empty((16, 200), device="meta"), [], [])
    assert tm.frozen_device(meta) == torch.device("meta")
    x, y = ROWS.x_test, ROWS.y_test
    ref = jm.eval_accuracy_hard(jfrozen, x, y, batch=128)
    for frozen in (as_numpy, as_tensors):
        assert tm.eval_accuracy_hard(frozen, x, y, batch=128) == ref
        assert tm.eval_accuracy_hard_packed(frozen, x, y, batch=97) == ref


def test_presets_and_config_match_reference():
    """Exact: the presets, layer specs and auto temperature."""
    assert set(tm.JSC_PRESETS) == set(jm.JSC_PRESETS)
    for name, cfg in jm.JSC_PRESETS.items():
        tcfg = tm.JSC_PRESETS[name]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        assert tcfg.tau_value == cfg.tau_value
        assert [dataclasses.astuple(s) for s in tcfg.layer_specs()] == \
            [dataclasses.astuple(s) for s in cfg.layer_specs()]


def test_port_init_is_seeded_and_shaped():
    """The port's own init: same generator seed, same parameters; shapes
    and ranges as the reference's init (values differ by design)."""
    cfg = tm.JSC_PRESETS["sm-10"]
    a = tm.init_dwn(torch.Generator().manual_seed(4), cfg, ROWS.x_train)
    b = tm.init_dwn(torch.Generator().manual_seed(4), cfg, ROWS.x_train)
    layer = a[0]["layers"][0]
    assert torch.equal(layer["scores"], b[0]["layers"][0]["scores"])
    assert tuple(layer["scores"].shape) == (10, 6, 3200)
    assert tuple(layer["tables"].shape) == (10, 64)
    assert float(layer["tables"].abs().max()) <= 1.0
    np.testing.assert_array_equal(
        a[1]["thresholds"].numpy(),
        jm.fit_thresholds(ROWS.x_train, jm.JSC_PRESETS["sm-10"].thermometer))
