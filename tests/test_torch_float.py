"""The float datapath: encode -> LUT layer(s) -> classify, and the float
fused kernel.

The port's ops (``encode``, ``evaluate``, ``classify`` in
``repro_torch.kernels.{thermometer,lut_eval,popcount}.ops`` and ``forward``
in ``repro_torch.kernels.fused.ops``) run their kernels' plain versions for
CPU tensors; these tests hold them against the reference's ops run with
``interpret=True`` on the same numpy-seeded inputs, and the whole float
path against the reference's ``apply_hard`` on a model frozen by the
reference.  The frozen model's ``thresholds``, ``mapping_idx`` and
``tables_bin`` are numpy arrays that the port's float ops take as they are
(the int {0,1} tables are cast to float32 by the ops): no new conversion of
weights is needed.  The CUDA kernels are held to these plain versions on
the card by ``test_torch_gpu.py``.

Tolerances: every comparison on {0,1} operands is exact (bits, counts held
in float32, the argmax).  Soft bits in the LUT layer are held within
``atol=1e-5`` and float tables in the fused kernel within ``atol=1e-4``,
the reference's own tolerances (``tests/test_kernels.py``): the two
evaluate the table in a different order of float operations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model as jm  # noqa: E402
from repro.data.jsc import load_jsc  # noqa: E402
from repro.kernels.fused import ops as jfused  # noqa: E402
from repro.kernels.lut_eval import kernel as jlk  # noqa: E402
from repro.kernels.lut_eval import ops as jlut  # noqa: E402
from repro.kernels.lut_eval import ref as jlref  # noqa: E402
from repro.kernels.popcount import ops as jpc  # noqa: E402
from repro.kernels.thermometer import ops as jth  # noqa: E402
from repro_torch.core.thermometer import quantize_fixed_point  # noqa: E402
from repro_torch.kernels.autotune import FusedConfig  # noqa: E402
from repro_torch.kernels.fused import kernel as KF  # noqa: E402
from repro_torch.kernels.fused import ops as tfused  # noqa: E402
from repro_torch.kernels.lut_eval import kernel as KL  # noqa: E402
from repro_torch.kernels.lut_eval import ops as tlut  # noqa: E402
from repro_torch.kernels.lut_eval import ref as tlref  # noqa: E402
from repro_torch.kernels.popcount import kernel as KP  # noqa: E402
from repro_torch.kernels.popcount import ops as tpc  # noqa: E402
from repro_torch.kernels.thermometer import kernel as KT  # noqa: E402
from repro_torch.kernels.thermometer import ops as tth  # noqa: E402

SOFT_ATOL = 1e-5
FLOAT_TABLE_ATOL = 1e-4


def _x_th(seed, B, F, T):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, F)).astype(np.float32)
    th = np.sort(rng.uniform(-1, 1, (F, T)).astype(np.float32), axis=1)
    return x, th


def _layer(seed, m, n, C, float_tables=False):
    rng = np.random.default_rng(seed)
    mapping = rng.integers(0, C, (m, n)).astype(np.int32)
    if float_tables:
        tables = rng.uniform(-1, 1, (m, 2 ** n)).astype(np.float32)
    else:
        tables = rng.integers(0, 2, (m, 2 ** n)).astype(np.int32)
    return mapping, tables


def _float_path(x, thresholds, mappings, tables, num_classes):
    """The float staged path through the port's public ops."""
    bits = tth.encode(x, thresholds)
    for mapping, tab in zip(mappings, tables):
        bits = tlut.evaluate(bits, mapping, tab)
    return tpc.classify(bits, num_classes)


@pytest.mark.parametrize("B,F,T", [(8, 4, 32), (37, 16, 200),
                                   (256, 16, 200), (5, 3, 7), (64, 1, 128)])
@pytest.mark.parametrize("flatten", [True, False])
def test_encode_matches_reference(B, F, T, flatten):
    """Exact float bits, flattened to (B, F*T) or as (B, F, T); the
    reference pads T to 128 lanes inside its op, the port does not."""
    x, th = _x_th(B + T, B, F, T)
    ref = jth.encode(jnp.asarray(x), jnp.asarray(th), flatten=flatten,
                     interpret=True)
    got = tth.encode(torch.from_numpy(x), torch.from_numpy(th),
                     flatten=flatten)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_encode_strict_compare_on_ties_and_nan():
    """Exact: on a PEN (1, 8) grid many x equal a threshold and compare
    false (strict '>'), as does NaN."""
    x, th = _x_th(3, 40, 16, 200)
    x, th = quantize_fixed_point(x, 8), quantize_fixed_point(th, 8)
    x[0, :4] = np.nan
    assert (x[:, :, None] == th[None]).sum() > 100
    ref = jth.encode(jnp.asarray(x), jnp.asarray(th), interpret=True)
    got = tth.encode(torch.from_numpy(x), torch.from_numpy(th))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[0, :4 * 200].any()


def test_encode_keeps_denormals():
    """The compare is IEEE: a denormal x is above a 0.0 threshold and a
    negative one below it.  (XLA on the CPU flushes denormals to zero, so
    the reference's op reads both as 0.0 and neither as above 0.0; the
    port's CUDA kernels are built without flush-to-zero and agree with
    this plain version.)"""
    x = np.asarray([[1e-40, -1e-40, 0.0]], np.float32)
    th = np.zeros((3, 2), np.float32)
    got = tth.encode(torch.from_numpy(x), torch.from_numpy(th))
    np.testing.assert_array_equal(got.numpy(), [[1, 1, 0, 0, 0, 0]])
    ref = jth.encode(jnp.asarray(x), jnp.asarray(th), interpret=True)
    assert not np.asarray(ref).any()


@pytest.mark.parametrize("B,m,n,C", [(16, 10, 6, 320), (33, 50, 6, 3200),
                                     (8, 7, 4, 64), (128, 360, 6, 3200)])
def test_evaluate_matches_reference(B, m, n, C):
    """Exact on {0,1} bits and {0,1} tables (the reference's op casts its
    tables to float32; so does the port's)."""
    rng = np.random.default_rng(m + n)
    bits = rng.integers(0, 2, (B, C)).astype(np.float32)
    mapping, tables = _layer(m, m, n, C)
    ref = jlut.evaluate(jnp.asarray(bits), jnp.asarray(mapping),
                        jnp.asarray(tables), interpret=True)
    got = tlut.evaluate(torch.from_numpy(bits), mapping, tables)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("float_tables", [False, True],
                         ids=["binary-tables", "float-tables"])
@pytest.mark.parametrize("n", [6, 3])
def test_evaluate_soft_bits_match_reference_kernel(float_tables, n):
    """Soft bits in [0, 1]: the multilinear interpolation, held to the
    reference's Pallas ``lut_eval`` kernel (interpret mode, its dense
    one-hot selection) within atol 1e-5."""
    rng = np.random.default_rng(10 + n)
    B, m, C = 16, 40, 320
    bits = rng.uniform(0, 1, (B, C)).astype(np.float32)
    mapping, tables = _layer(20 + n, m, n, C, float_tables)
    sel = jlref.selection_onehot(jnp.asarray(mapping), C)
    ref = jlk.lut_eval(jnp.asarray(bits), sel,
                       jnp.asarray(tables, jnp.float32), fan_in=n,
                       interpret=True)
    got = tlut.evaluate(torch.from_numpy(bits), mapping, tables)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=SOFT_ATOL)
    assert np.abs(got.numpy() - np.round(got.numpy())).max() > 0.01


def test_selection_onehot_matches_reference_and_equals_the_gather():
    """Exact: the port's one-hot matrix equals the reference's, and
    ``bits @ sel`` equals the gather ``bits[:, mapping]`` that the kernels
    do instead, on {0,1} and on soft bits."""
    mapping, _ = _layer(5, 30, 6, 200)
    ref = np.asarray(jlref.selection_onehot(jnp.asarray(mapping), 200))
    sel = tlref.selection_onehot(torch.from_numpy(mapping), 200)
    assert sel.dtype == torch.float32 and tuple(sel.shape) == (200, 180)
    np.testing.assert_array_equal(sel.numpy(), ref)
    assert (sel.sum(0) == 1).all()
    rng = np.random.default_rng(6)
    for bits in (rng.integers(0, 2, (9, 200)).astype(np.float32),
                 rng.uniform(0, 1, (9, 200)).astype(np.float32)):
        b = torch.from_numpy(bits)
        assert torch.equal(b @ sel, b[:, torch.from_numpy(mapping)
                                      .reshape(-1).long()])


@pytest.mark.parametrize("B,classes,group", [(16, 5, 2), (37, 5, 72),
                                             (512, 10, 13), (4, 2, 1)])
def test_classify_matches_reference(B, classes, group):
    """Exact counts and first argmax."""
    rng = np.random.default_rng(B + classes)
    bits = (rng.random((B, classes * group)) < 0.4).astype(np.float32)
    rc, ri = jpc.classify(jnp.asarray(bits), classes, interpret=True)
    counts, idx = tpc.classify(torch.from_numpy(bits), classes)
    assert counts.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


def test_classify_ties_go_to_lower_class():
    """Exact: counts (2, 2, 0) give class 0, as in the reference."""
    bits = np.asarray([[1, 1, 1, 1, 0, 0]], np.float32)
    rc, ri = jpc.classify(jnp.asarray(bits), 3, interpret=True)
    counts, idx = tpc.classify(torch.from_numpy(bits), 3)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    assert int(idx[0]) == int(ri[0]) == 0


# (B, F, T, m, float tables, config): the reference's shapes, a ragged B,
# m = 7 with 5 classes (two LUTs count for no class), float tables, and a
# block_m that does not divide m
FORWARD_CASES = {
    "8x4x32-m10": (8, 4, 32, 10, False, None),
    "37x16x200-m50": (37, 16, 200, 50, False, None),
    "64x16x200-m360": (64, 16, 200, 360, False, None),
    "ragged-13": (13, 16, 200, 50, False, FusedConfig(block_b=4)),
    "m7-c5": (9, 3, 7, 7, False, None),
    "float-tables": (64, 16, 200, 360, True, None),
    "block_m-7": (37, 16, 200, 50, False, FusedConfig(block_m=7)),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_reference(case):
    """The float fused op equals the reference's ``forward``: exact on
    {0,1} tables; with float tables the counts within 1e-4 and the argmax
    exact where the top two counts differ by more than that."""
    B, F, T, m, float_tables, config = FORWARD_CASES[case]
    x, th = _x_th(m, B, F, T)
    mapping, tables = _layer(m + 1, m, 6, F * T, float_tables)
    rc, ri = jfused.forward(jnp.asarray(x), jnp.asarray(th),
                            jnp.asarray(mapping), jnp.asarray(tables), 5,
                            interpret=True)
    rc, ri = np.asarray(rc), np.asarray(ri)
    counts, idx = tfused.forward(torch.from_numpy(x), torch.from_numpy(th),
                                 mapping, tables, 5, config=config)
    counts, idx = counts.numpy(), idx.numpy()
    if not float_tables:
        np.testing.assert_array_equal(counts, rc)
        np.testing.assert_array_equal(idx, ri)
        return
    np.testing.assert_allclose(counts, rc, rtol=0, atol=FLOAT_TABLE_ATOL)
    top2 = np.sort(rc, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > FLOAT_TABLE_ATOL
    assert clear.sum() > B // 2
    np.testing.assert_array_equal(idx[clear], ri[clear])


def test_forward_counts_only_whole_class_groups():
    """m = 7, 5 classes: LUT l counts for class l // 1 for l < 5; LUTs 5
    and 6 count for nothing (the reference's op), so their tables do not
    change the counts."""
    x, th = _x_th(1, 9, 3, 7)
    mapping, tables = _layer(2, 7, 6, 21)
    base = tfused.forward(torch.from_numpy(x), th, mapping, tables, 5)
    tables[5:] = 1 - tables[5:]
    again = tfused.forward(torch.from_numpy(x), th, mapping, tables, 5)
    assert torch.equal(base[0], again[0]) and torch.equal(base[1], again[1])
    assert base[0].sum(-1).max() <= 5


def test_forward_agrees_with_float_staged_path():
    """Exact: the float fused op == encode -> evaluate -> classify, the
    twin of the reference's ``test_fused_agrees_with_staged_pipeline``."""
    x, th = _x_th(9, 24, 16, 200)
    mapping, tables = _layer(9, 50, 6, 3200)
    for B in (0, 1, 24):
        xt = torch.from_numpy(x[:B])
        stage_c, stage_i = _float_path(xt, th, [mapping], [tables], 5)
        counts, idx = tfused.forward(xt, th, mapping, tables, 5)
        assert torch.equal(counts, stage_c) and torch.equal(idx, stage_i)


ROWS = load_jsc(2000, 64, seed=2)


def _jax_frozen(lut_counts, frac_bits, seed):
    """A model frozen by the reference from numpy-drawn parameters."""
    cfg = jm.DWNConfig(lut_counts=lut_counts)
    rng = np.random.default_rng(seed)
    layers = []
    for s in cfg.layer_specs():
        layers.append({
            "scores": jnp.asarray(rng.standard_normal(
                (s.num_luts, s.fan_in, s.num_candidates), np.float32)),
            "tables": jnp.asarray(rng.uniform(
                -1, 1, (s.num_luts, s.table_size)).astype(np.float32))})
    th = jm.fit_thresholds(ROWS.x_train, cfg.thermometer)
    return jm.freeze({"layers": layers}, {"thresholds": jnp.asarray(th)},
                     cfg, input_frac_bits=frac_bits)


@pytest.mark.parametrize("lut_counts,frac_bits", [
    ((2400,), None), ((2400,), 8), ((120, 50), None), ((120, 50), 8)],
    ids=["lg-2400", "lg-2400-pen9", "stack-120-50", "stack-120-50-pen9"])
def test_float_path_matches_apply_hard(lut_counts, frac_bits):
    """Exact: the float ops on a model frozen by the reference give the
    counts of the reference's ``apply_hard`` and its first argmax, at
    B = 1 and 64; so does the float fused op on one-layer models."""
    frozen = _jax_frozen(lut_counts, frac_bits, seed=len(lut_counts) + 7)
    ref_fn = jax.jit(lambda x: jm.apply_hard(frozen, x))
    for B in (1, 64):
        x = ROWS.x_test[:B]
        ref = np.asarray(ref_fn(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        if frac_bits is not None:
            xt = quantize_fixed_point(xt, frac_bits)
        counts, idx = _float_path(xt, frozen.thresholds, frozen.mapping_idx,
                                  frozen.tables_bin, 5)
        np.testing.assert_array_equal(counts.numpy(), ref)
        np.testing.assert_array_equal(idx.numpy(), ref.argmax(-1))
        if len(lut_counts) == 1:
            counts, idx = tfused.forward(xt, frozen.thresholds,
                                         frozen.mapping_idx[0],
                                         frozen.tables_bin[0], 5)
            np.testing.assert_array_equal(counts.numpy(), ref)
            np.testing.assert_array_equal(idx.numpy(), ref.argmax(-1))


def test_cpu_tensors_take_the_plain_versions_without_launching():
    """On CPU tensors the float wrappers run their plain versions and
    count no launch; a tensor on another device type is refused."""
    for K in (KT, KL, KP, KF):
        K.reset_launch_counts()
    x, th = _x_th(4, 8, 16, 200)
    mapping, tables = _layer(4, 50, 6, 3200)
    _float_path(torch.from_numpy(x), th, [mapping], [tables], 5)
    tfused.forward(torch.from_numpy(x), th, mapping, tables, 5)
    for K in (KT, KL, KP, KF):
        assert not any(K.launch_counts().values()), K.launch_counts()
    meta = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        KT.thermometer_encode(meta, torch.from_numpy(th))
    with pytest.raises(ValueError, match="cpu or cuda"):
        KL.lut_eval(meta, meta.int(), meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        KP.popcount_classify(meta, 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        KF.fused_dwn(meta, meta, meta.int(), meta, 4)


def test_float_ops_refuse_bad_operands():
    """Out-of-range wires, tables of the wrong shape and classes that do
    not split the outputs raise ``ValueError``."""
    x, th = _x_th(6, 4, 16, 200)
    bits = tth.encode(torch.from_numpy(x), th)
    mapping, tables = _layer(6, 10, 6, 3200)
    bad_map = mapping.copy()
    bad_map[2, 3] = 3200
    with pytest.raises(ValueError, match="mapping indices"):
        tlut.evaluate(bits, bad_map, tables)
    with pytest.raises(ValueError, match="mapping indices"):
        tfused.forward(torch.from_numpy(x), th, bad_map, tables, 5)
    bad_map[2, 3] = -1
    with pytest.raises(ValueError, match="mapping indices"):
        tlut.evaluate(bits, bad_map, tables)
    with pytest.raises(ValueError, match="tables have shape"):
        tlut.evaluate(bits, mapping, tables[:, :32])
    out = tlut.evaluate(bits, mapping, tables)
    with pytest.raises(ValueError, match="equal class groups"):
        tpc.classify(out, 3)
    with pytest.raises(ValueError, match="equal class groups"):
        tpc.classify(out, 0)
    with pytest.raises(ValueError, match="block_m"):
        FusedConfig(block_m=0)


def test_float_ops_go_to_the_card_unless_given_cpu_tensors(monkeypatch):
    """Inputs that are not a tensor go to the CUDA card: without one each
    float op raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, th = _x_th(7, 4, 16, 200)
    mapping, tables = _layer(7, 10, 6, 3200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tth.encode(x, th)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlut.evaluate(np.zeros((4, 3200), np.float32), mapping, tables)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpc.classify(np.zeros((4, 10), np.float32), 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfused.forward(x, th, mapping, tables, 5)
    assert tth.encode(torch.from_numpy(x), th).shape == (4, 3200)


def test_fused_config_carries_block_m():
    """``block_m`` defaults to 128 as in the reference and round-trips
    through ``to_dict``/``from_dict``; unknown keys are ignored and
    missing ones default, as in the reference."""
    from repro.kernels.autotune import FusedConfig as JConfig
    cfg = FusedConfig("batch-major", block_b=16, block_m=64)
    assert FusedConfig.from_dict(cfg.to_dict()) == cfg
    assert FusedConfig().block_m == JConfig().block_m == 128
    assert FusedConfig.from_dict({"block_m": 7, "label": "x"}) == \
        FusedConfig(block_m=7)
    assert JConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
