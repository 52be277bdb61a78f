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


# -- training: the EFD / softmax-STE layer against jax.grad ---------------

GRAD_TOL = 1e-5


@pytest.mark.parametrize("luts", [(50,), (360,), (120, 50)])
def test_loss_and_gradients_match_jax_grad(luts):
    """Forward bits, logits and loss exact; every gradient leaf of
    ``loss_fn_from_bits`` within 1e-5 of its largest magnitude (float32
    sums in another order), at sm-50 and md-360 width and on a (120, 50)
    two-layer stack, whose second layer sends a bits gradient back
    through the first.  Params are the reference's, carried across."""
    from repro.core import model as jm
    from repro.data.jsc import load_jsc
    from repro_torch.core import model as tm
    cfg_j, cfg_t = (jm.DWNConfig(lut_counts=luts),
                    tm.DWNConfig(lut_counts=luts))
    data = load_jsc(600, 100, seed=0)
    p, b = jm.init_dwn(jax.random.PRNGKey(1), cfg_j, data.x_train)
    rows = np.random.default_rng(0).permutation(600)[:128]
    bits = np.asarray(jm.encode(jnp.asarray(data.x_train[rows]),
                                b["thresholds"])).astype(np.uint8)
    y = data.y_train[rows]
    (loss_j, logits_j), grads_j = jax.value_and_grad(
        jm.loss_fn_from_bits, has_aux=True)(p, cfg_j, jnp.asarray(bits),
                                            jnp.asarray(y))
    tp, _ = tm.params_from_numpy(p, b)
    leaves = [layer[k].requires_grad_() for layer in tp["layers"]
              for k in ("scores", "tables")]
    loss_t, logits_t = tm.loss_fn_from_bits(
        tp, cfg_t, torch.from_numpy(bits), torch.from_numpy(y))
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_array_equal(logits_t.detach().numpy(),
                                  np.asarray(logits_j))
    assert float(loss_t.detach()) == float(loss_j)
    want = [np.asarray(layer[k]) for layer in grads_j["layers"]
            for k in ("scores", "tables")]
    for got, ref in zip(grads_t, want):
        assert got.shape == ref.shape
        err = np.abs(got.numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), err


def test_lut_layer_vjp_matches_reference():
    """Within 1e-5 of each cotangent's largest magnitude: the layer's
    vector-Jacobian product for a random cotangent, bits gradient
    included (``lut_layer_apply``), against ``jax.vjp``; the stop-gradient
    twin returns no bits gradient and the same scores and tables ones."""
    rng = np.random.default_rng(3)
    B, C, m, n = 9, 40, 12, 4
    bits = rng.integers(0, 2, (B, C)).astype(np.float32)
    scores = rng.normal(0, 0.5, (m, n, C)).astype(np.float32)
    tables = rng.uniform(-1.2, 1.2, (m, 2 ** n)).astype(np.float32)
    cot = rng.normal(size=(B, m)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda bt, s, t: jll.lut_layer_apply({"scores": s, "tables": t},
                                             bt),
        jnp.asarray(bits), jnp.asarray(scores), jnp.asarray(tables))
    want = vjp(jnp.asarray(cot))
    tb, ts, tt = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (bits, scores, tables))
    out_t = tll.lut_layer_apply({"scores": ts, "tables": tt}, tb)
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    got = torch.autograd.grad(out_t, (tb, ts, tt), torch.from_numpy(cot))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max()
    ts2, tt2 = (torch.from_numpy(a.copy()).requires_grad_()
                for a in (scores, tables))
    out2 = tll.lut_layer_apply_stopgrad({"scores": ts2, "tables": tt2},
                                        torch.from_numpy(bits))
    g2 = torch.autograd.grad(out2, (ts2, tt2), torch.from_numpy(cot))
    for a, b in zip(g2, got[1:]):
        assert torch.equal(a, b)
