"""Port vs reference: the hard LUT-layer paths (``core/lut_layer.py``) and
the classifier.  Every comparison is exact (integer bits and counts)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import classifier as jcl  # noqa: E402
from repro.core import lut_layer as jll  # noqa: E402
from repro.core.bitpack import PackedBits  # noqa: E402
from repro_torch.core import classifier as tcl  # noqa: E402
from repro_torch.core import lut_layer as tll  # noqa: E402
from repro_torch.core.bitpack import PackedBits as TPackedBits  # noqa: E402


def _layer(rng, B, C, m, n):
    bits = rng.integers(0, 2, (B, C)).astype(np.float32)
    mapping = rng.integers(0, C, (m, n)).astype(np.int32)
    tables = rng.integers(0, 2, (m, 2 ** n)).astype(np.int32)
    return bits, mapping, tables


@pytest.mark.parametrize("B,C,m,n", [(1, 3200, 10, 6), (37, 3200, 50, 6),
                                     (8, 120, 64, 3), (5, 33, 7, 4)])
def test_lut_eval_hard_matches_reference(B, C, m, n):
    """Exact: float and packed hard paths equal the reference's."""
    bits, mapping, tables = _layer(np.random.default_rng(m), B, C, m, n)
    ref = np.asarray(jax.jit(jll.lut_eval_hard)(
        jnp.asarray(bits), jnp.asarray(mapping), jnp.asarray(tables)))
    got = tll.lut_eval_hard(torch.from_numpy(bits),
                            torch.from_numpy(mapping),
                            torch.from_numpy(tables))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)

    ref_p = jax.jit(lambda b, i, t: jll.lut_eval_hard_packed(
        PackedBits.pack(b), i, t))(jnp.asarray(bits), jnp.asarray(mapping),
                                   jnp.asarray(tables))
    got_p = tll.lut_eval_hard_packed(TPackedBits.pack(
        torch.from_numpy(bits)), torch.from_numpy(mapping),
        torch.from_numpy(tables))
    assert got_p.num_bits == ref_p.num_bits == m
    np.testing.assert_array_equal(got_p.words.numpy().astype(np.uint32),
                                  np.asarray(ref_p.words))


def test_first_max_index_ties_to_low_index():
    """Exact: first index of the maximum, ties to the lowest, as the
    reference; the classifier's predict follows the same rule."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (50, 4, 7)).astype(np.float32)   # many ties
    ref = np.asarray(jll.first_max_index(jnp.asarray(x)))
    got = tll.first_max_index(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    counts = np.array([[3, 5, 5, 1], [2, 2, 2, 2], [0, 0, 0, 9]],
                      np.float32)
    np.testing.assert_array_equal(
        tcl.predict(torch.from_numpy(counts)).numpy(), [1, 0, 3])
    np.testing.assert_array_equal(
        tcl.predict(torch.from_numpy(counts)).numpy(),
        np.asarray(jcl.predict(jnp.asarray(counts))))


def test_freeze_helpers_and_group_popcount_match_reference():
    """Exact: finalize_mapping / binarize_tables on the same scores and
    tables, and group popcounts (float and packed) of the same bits."""
    rng = np.random.default_rng(1)
    params = {"scores": rng.normal(size=(40, 6, 200)).astype(np.float32),
              "tables": rng.uniform(-1, 1, (40, 64)).astype(np.float32)}
    params["scores"][:, :, 7] = params["scores"].max() + 1   # exact ties
    params["scores"][:, :, 9] = params["scores"].max()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    np.testing.assert_array_equal(tll.finalize_mapping(tp).numpy(),
                                  np.asarray(jll.finalize_mapping(jp)))
    np.testing.assert_array_equal(tll.binarize_tables(tp).numpy(),
                                  np.asarray(jll.binarize_tables(jp)))
    bits = rng.integers(0, 2, (11, 50)).astype(np.float32)
    ref = np.asarray(jcl.group_popcount(jnp.asarray(bits), 5))
    np.testing.assert_array_equal(
        tcl.group_popcount(torch.from_numpy(bits), 5).numpy(), ref)
    np.testing.assert_array_equal(
        tcl.group_popcount_packed(TPackedBits.pack(torch.from_numpy(bits)),
                                  5).numpy(), ref)
    labels = rng.integers(0, 5, 11)
    assert float(tcl.accuracy(torch.from_numpy(ref.copy()),
                              torch.from_numpy(labels))) == \
        float(jcl.accuracy(jnp.asarray(ref), jnp.asarray(labels)))
