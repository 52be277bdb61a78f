"""Port vs reference: thermometer encoding (``core/thermometer.py``).

The same numpy rows go through both packages.  Every comparison is exact:
thresholds are fit with the same float64 numpy code and the compares are
float32 on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import thermometer as jth  # noqa: E402
from repro.data.jsc import load_jsc  # noqa: E402
from repro_torch.core import thermometer as tth  # noqa: E402


@pytest.fixture(scope="module")
def rows():
    return load_jsc(1500, 300, seed=3)


@pytest.mark.parametrize("mode", ["distributive", "uniform", "gaussian"])
@pytest.mark.parametrize("T", [200, 13])
def test_fit_thresholds_identical(rows, mode, T):
    """Exact: identical float32 (F, T) thresholds for every placement."""
    jspec = jth.ThermometerSpec(16, T, mode)
    tspec = tth.ThermometerSpec(16, T, mode)
    ref = jth.fit_thresholds(rows.x_train, jspec)
    got = tth.fit_thresholds(rows.x_train, tspec)
    assert got.dtype == np.float32 and got.shape == (16, T)
    assert got.tobytes() == ref.tobytes()
    assert tth.PLACEMENTS == jth.PLACEMENTS


def test_normalize_and_norm_ppf_identical():
    """Exact: the copied numpy helpers give the reference's values."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 16)).astype(np.float32)
    for a, b in zip(tth.normalize_to_unit(x), jth.normalize_to_unit(x)):
        np.testing.assert_array_equal(a, b)
    q = np.linspace(0.001, 0.999, 501)
    np.testing.assert_array_equal(tth._norm_ppf(q), jth._norm_ppf(q))


@pytest.mark.parametrize("T", [200, 13])
def test_encode_and_encode_packed_identical(rows, T):
    """Exact: float bits and packed words (incl. a ragged last word at
    F*T = 208) equal the reference's."""
    th = jth.fit_thresholds(rows.x_train, jth.ThermometerSpec(16, T))
    x = rows.x_test[:37]
    ref = np.asarray(jth.encode(jnp.asarray(x), jnp.asarray(th)))
    got = tth.encode(torch.from_numpy(x), torch.from_numpy(th))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tth.encode(torch.from_numpy(x), torch.from_numpy(th),
                   flatten=False).numpy(),
        np.asarray(jth.encode(jnp.asarray(x), jnp.asarray(th),
                              flatten=False)))
    ref_p = jth.encode_packed(jnp.asarray(x), jnp.asarray(th))
    got_p = tth.encode_packed(torch.from_numpy(x), torch.from_numpy(th))
    assert got_p.num_bits == ref_p.num_bits == 16 * T
    np.testing.assert_array_equal(
        got_p.words.numpy().astype(np.uint32), np.asarray(ref_p.words))


@pytest.mark.parametrize("frac_bits", [3, 8])
def test_quantize_fixed_point_identical(frac_bits):
    """Exact: torch and numpy branches both match the reference in
    float32, including exact half-way points (round half to even) and the
    clip at 1 - 2^-n."""
    rng = np.random.default_rng(frac_bits)
    v = rng.uniform(-1.2, 1.2, 4000).astype(np.float32)
    half = (np.arange(-2 ** frac_bits, 2 ** frac_bits) + 0.5) \
        / 2 ** frac_bits
    v = np.concatenate([v, half.astype(np.float32)])
    ref = np.asarray(jth.quantize_fixed_point(jnp.asarray(v), frac_bits))
    got_t = tth.quantize_fixed_point(torch.from_numpy(v), frac_bits)
    assert got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy(), ref)
    got_np = tth.quantize_fixed_point(v, frac_bits)
    assert got_np.dtype == np.float32
    np.testing.assert_array_equal(got_np, jth.quantize_fixed_point(
        v, frac_bits))
