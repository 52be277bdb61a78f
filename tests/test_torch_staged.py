"""The staged packed datapath: encode -> LUT layer(s) -> classify.

The port's ops (``repro_torch.kernels.{thermometer,lut_eval,popcount}.ops``)
run their kernels' plain versions for CPU tensors; these tests hold them
against the reference's ops run with ``interpret=True`` on the same
numpy-seeded inputs, and the whole staged path against the reference's
``apply_hard_packed`` on a model frozen by the reference.  The frozen
model's ``thresholds``, ``mapping_idx`` and ``tables_bin`` are numpy
arrays that the port's ops take as they are: no conversion of weights is
needed.  The CUDA kernels are held to these plain versions on the card by
``test_torch_gpu.py``.  Every comparison is exact: words and counts are
integers (counts held in float32) and the argmax is an integer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitpack as jbp  # noqa: E402
from repro.core import model as jm  # noqa: E402
from repro.data.jsc import load_jsc  # noqa: E402
from repro.kernels.lut_eval import ops as jlut  # noqa: E402
from repro.kernels.popcount import ops as jpc  # noqa: E402
from repro.kernels.thermometer import ops as jth  # noqa: E402
from repro_torch.core import bitpack as tbp  # noqa: E402
from repro_torch.core.thermometer import quantize_fixed_point  # noqa: E402
from repro_torch.kernels.fused import ops as tfused  # noqa: E402
from repro_torch.kernels.lut_eval import kernel as KL  # noqa: E402
from repro_torch.kernels.lut_eval import ops as tlut  # noqa: E402
from repro_torch.kernels.popcount import kernel as KP  # noqa: E402
from repro_torch.kernels.popcount import ops as tpc  # noqa: E402
from repro_torch.kernels.thermometer import kernel as KT  # noqa: E402
from repro_torch.kernels.thermometer import ops as tth  # noqa: E402


def _x_th(seed, B, F, T):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, F)).astype(np.float32)
    th = np.sort(rng.uniform(-1, 1, (F, T)).astype(np.float32), axis=1)
    return x, th


def _staged(x, thresholds, mappings, tables, num_classes):
    """The staged path through the port's public ops."""
    packed = tth.encode_packed(x, thresholds)
    for mapping, tab in zip(mappings, tables):
        packed = tlut.evaluate_packed(packed, mapping, tab)
    return tpc.classify_packed(packed, num_classes)


@pytest.mark.parametrize("B,F,T", [(8, 4, 32), (37, 16, 200), (64, 1, 128),
                                   (9, 3, 7)])
def test_encode_packed_matches_reference(B, F, T):
    """Exact words.  (9, 3, 7) has F*T = 21: the reference takes its jnp
    fallback there, the port writes a ragged last word with zero pad
    bits."""
    x, th = _x_th(B, B, F, T)
    ref = jth.encode_packed(jnp.asarray(x), jnp.asarray(th), interpret=True)
    got = tth.encode_packed(torch.from_numpy(x), torch.from_numpy(th))
    assert got.num_bits == ref.num_bits == F * T
    assert got.words.dtype == torch.int64
    assert tbp.words_to_numpy(got.words).tobytes() == \
        np.asarray(ref.words).tobytes()


def test_encode_packed_strict_compare_on_ties_and_nan():
    """Exact: on a PEN (1, 8) grid many x equal a threshold and compare
    false (strict '>'), as does NaN."""
    x, th = _x_th(3, 40, 16, 200)
    x, th = quantize_fixed_point(x, 8), quantize_fixed_point(th, 8)
    x[0, :4] = np.nan
    assert (x[:, :, None] == th[None]).sum() > 100
    ref = jth.encode_packed(jnp.asarray(x), jnp.asarray(th), interpret=True)
    got = tth.encode_packed(torch.from_numpy(x), torch.from_numpy(th))
    np.testing.assert_array_equal(tbp.words_to_numpy(got.words),
                                  np.asarray(ref.words))
    assert not got.unpack()[0, :4 * 200].any()


@pytest.mark.parametrize("B,m,C", [(16, 10, 320), (33, 50, 3200),
                                   (128, 360, 3200)])
def test_evaluate_packed_matches_reference(B, m, C):
    """Exact output words from either word carrier; m is not padded in
    the result's bit count."""
    rng = np.random.default_rng(m)
    bits = rng.integers(0, 2, (B, C)).astype(np.float32)
    mapping = rng.integers(0, C, (m, 6)).astype(np.int32)
    tables = rng.integers(0, 2, (m, 64)).astype(np.int32)
    ref = jlut.evaluate_packed(jbp.PackedBits.pack(jnp.asarray(bits)),
                               jnp.asarray(mapping), jnp.asarray(tables),
                               interpret=True)
    packed = tbp.PackedBits.pack(torch.from_numpy(bits))
    patterns = tbp.PackedBits(tbp.to_word_pattern(packed.words), C)
    for p in (packed, patterns):
        got = tlut.evaluate_packed(p, torch.from_numpy(mapping),
                                   torch.from_numpy(tables))
        assert got.num_bits == ref.num_bits == m
        assert tbp.words_to_numpy(got.words).tobytes() == \
            np.asarray(ref.words).tobytes()


def test_packed_wire_indices_match_reference():
    """Exact: word index and bit offset of every wire."""
    mapping = np.random.default_rng(1).integers(0, 3200, (50, 6)).astype(
        np.int32)
    ref = jlut.packed_wire_indices(jnp.asarray(mapping))
    got = tlut.packed_wire_indices(torch.from_numpy(mapping))
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("B,classes,group", [(16, 5, 2), (37, 5, 72),
                                             (512, 10, 13)])
def test_classify_packed_matches_reference(B, classes, group):
    """Exact counts and first argmax; class groups straddle words."""
    rng = np.random.default_rng(B + classes)
    bits = (rng.random((B, classes * group)) < 0.4).astype(np.float32)
    rc, ri = jpc.classify_packed(jbp.PackedBits.pack(jnp.asarray(bits)),
                                 classes, interpret=True)
    counts, idx = tpc.classify_packed(
        tbp.PackedBits.pack(torch.from_numpy(bits)), classes)
    assert counts.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


def test_classify_packed_ties_go_to_lower_class():
    """Exact: counts (2, 2, 0) give class 0, as in the reference."""
    bits = np.asarray([[1, 1, 1, 1, 0, 0]], np.float32)
    rc, ri = jpc.classify_packed(jbp.PackedBits.pack(jnp.asarray(bits)), 3,
                                 interpret=True)
    counts, idx = tpc.classify_packed(
        tbp.PackedBits.pack(torch.from_numpy(bits)), 3)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    assert int(idx[0]) == int(ri[0]) == 0


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
def test_staged_path_matches_apply_hard_packed(lut_counts, frac_bits):
    """Exact: the staged ops on a model frozen by the reference give the
    counts of the reference's ``apply_hard_packed`` and its first argmax,
    at B = 1 and 64."""
    frozen = _jax_frozen(lut_counts, frac_bits, seed=len(lut_counts))
    ref_fn = jax.jit(lambda x: jm.apply_hard_packed(frozen, x))
    for B in (1, 64):
        x = ROWS.x_test[:B]
        ref = np.asarray(ref_fn(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        if frac_bits is not None:
            xt = quantize_fixed_point(xt, frac_bits)
        counts, idx = _staged(xt, frozen.thresholds, frozen.mapping_idx,
                              frozen.tables_bin, 5)
        np.testing.assert_array_equal(counts.numpy(), ref)
        np.testing.assert_array_equal(idx.numpy(), ref.argmax(-1))


@pytest.mark.parametrize("F,T,lut_counts", [(16, 200, (360,)),
                                            (5, 13, (40, 20))])
def test_staged_path_matches_fused_plain(F, T, lut_counts):
    """Exact: staged == the port's fused packed path (K2's plain version,
    through ``make_forward_packed`` and ``forward_packed``) on ragged B
    including 0 and 1; (5, 13) has a ragged thermometer word."""
    rng = np.random.default_rng(F + T)
    x, th = _x_th(F, 37, F, T)
    maps, tabs, cand = [], [], F * T
    for m in lut_counts:
        maps.append(torch.from_numpy(rng.integers(0, cand, (m, 6))))
        tabs.append(torch.from_numpy(rng.integers(0, 2, (m, 64))))
        cand = m
    th_t = torch.from_numpy(th)
    fused = tfused.make_forward_packed(th_t, maps, tabs, 5)
    for B in (0, 1, 37):
        xt = torch.from_numpy(x[:B])
        counts, idx = _staged(xt, th_t, maps, tabs, 5)
        ref_c, ref_i = fused(xt)
        assert torch.equal(counts, ref_c) and torch.equal(idx, ref_i)
        once = tfused.forward_packed(xt, th_t, maps, tabs, 5)
        assert torch.equal(once[0], ref_c) and torch.equal(once[1], ref_i)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; a tensor on another device type is refused."""
    for K in (KT, KL, KP):
        K.reset_launch_counts()
    x, th = _x_th(4, 8, 16, 200)
    mapping = np.random.default_rng(4).integers(0, 3200, (50, 6))
    tables = np.random.default_rng(5).integers(0, 2, (50, 64))
    _staged(torch.from_numpy(x), torch.from_numpy(th), [mapping], [tables],
            5)
    assert KT.launch_counts() == {"thermometer_encode": 0,
                                  "thermometer_encode_packed": 0}
    assert KL.launch_counts() == {"lut_eval": 0, "lut_eval_packed": 0}
    assert KP.launch_counts() == {"popcount_classify": 0,
                                  "popcount_classify_packed": 0}
    meta = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        KT.thermometer_encode_packed(meta, torch.from_numpy(th))
    with pytest.raises(ValueError, match="cpu or cuda"):
        KP.popcount_classify_packed(meta.int(), meta.int())


def test_ops_refuse_bad_operands():
    """Out-of-range wires, non-binary tables, words too few for their
    bits and classes that do not split the bits raise ``ValueError``."""
    bits = torch.from_numpy(
        np.random.default_rng(6).integers(0, 2, (4, 100)))
    packed = tbp.PackedBits.pack(bits)
    mapping = np.zeros((10, 6), np.int64)
    tables = np.zeros((10, 64), np.int64)
    bad_map = mapping.copy()
    bad_map[2, 3] = 100
    with pytest.raises(ValueError, match="mapping indices"):
        tlut.evaluate_packed(packed, bad_map, tables)
    bad_tab = tables.copy()
    bad_tab[1, 7] = 2
    with pytest.raises(ValueError, match="only 0 and 1"):
        tlut.evaluate_packed(packed, mapping, bad_tab)
    with pytest.raises(ValueError, match="cannot hold"):
        tlut.evaluate_packed(tbp.PackedBits(packed.words, 200), mapping,
                             tables)
    with pytest.raises(ValueError, match="equal groups"):
        tpc.classify_packed(packed, 3)
    with pytest.raises(ValueError, match="at least 1"):
        tpc.classify_packed(packed, 0)


def test_ops_go_to_the_card_unless_given_cpu_tensors(monkeypatch):
    """Features that are not a tensor go to the CUDA card: without one the
    op raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, th = _x_th(7, 4, 16, 200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tth.encode_packed(x, th)
    assert tth.encode_packed(torch.from_numpy(x), th).num_bits == 3200


def test_word_carriers_are_interchangeable():
    """Exact: int32 bit patterns and int64 carriers of the same words
    unpack, convert to numpy and convert to the device's carrier alike."""
    v = np.random.default_rng(8).integers(0, 2 ** 32, (3, 7),
                                          dtype=np.uint64)
    v[0, :2] = (0, 2 ** 32 - 1)
    carrier = torch.from_numpy(v.astype(np.int64))
    pattern = tbp.to_word_pattern(carrier)
    assert pattern.dtype == torch.int32
    for words in (carrier, pattern):
        assert tbp.words_to_numpy(words).tobytes() == \
            v.astype(np.uint32).tobytes()
        assert torch.equal(tbp.device_words(words), carrier)
        assert torch.equal(tbp.PackedBits(words, 200).unpack(),
                           tbp.PackedBits(carrier, 200).unpack())
    assert tbp.device_words(carrier) is carrier
