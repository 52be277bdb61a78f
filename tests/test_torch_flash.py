"""The port's flash attention (``repro_torch.kernels.flash_attn``) against
the reference's Pallas kernel in interpret mode, its op and its oracle.

On the CPU the port's wrapper runs its plain version, so these tests hold
that plain version — the function the CUDA kernel is held to on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``) — to the reference.
Inputs come from numpy seeds.  Tolerances are the reference's own bars
for the flash kernel (``tests/test_flash_kernel.py``): 2e-3 in float32
and 2e-2 in bf16 (absolute and relative, as ``assert_allclose``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import ops as jops  # noqa: E402
from repro.kernels.flash_attn.kernel import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attn.ref import attention_ref as jref  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attn import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import attention_ref as tref  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, S, H, KH, hd, dtype):
    """q (scaled by 0.5), k, v as (jax, torch) pairs of the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5,
            rng.standard_normal((B, S, KH, hd)).astype(np.float32),
            rng.standard_normal((B, S, KH, hd)).astype(np.float32)]
    js = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    ts = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return js, ts


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _fold_j(t, g):
    """(B, S, K, hd) jax -> (B*K*g, S, hd), KV repeated per group."""
    t = jnp.repeat(t, g, axis=2) if g > 1 else t
    B, S, H, hd = t.shape
    return t.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("S", [1, 8, 33, 56, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_matches_reference_kernel_op_and_oracle(dtype, S):
    """Causal, GQA 4:2 and 4:4: the port's ``attend`` against the
    reference's ``ops.attend`` in interpret mode (which pads S to its
    block) and against ``attention_ref``; the port's plain version in the
    reference's (BH, S, hd) layout against the reference's Pallas kernel
    in interpret mode and its oracle.  Output dtype is q's."""
    tol = TOL[dtype]
    for i, (H, KH) in enumerate([(4, 2), (4, 4)]):
        (jq, jk, jv), (tq, tk, tv) = _qkv(S + 10 * i, 2, S, H, KH, 16, dtype)
        got = tops.attend(tq, tk, tv, causal=True, block=8)
        assert got.dtype == TDT[dtype] and got.shape == tq.shape
        _close(got, jops.attend(jq, jk, jv, causal=True, block=8,
                                interpret=True), tol)
        g = H // KH
        want = jref(_fold_j(jq, 1), _fold_j(jk, g), _fold_j(jv, g),
                    causal=True)
        _close(got.transpose(1, 2).reshape(2 * H, S, 16), want, tol)
    # the reference kernel's own layout, one (b, h) per row
    fq, fk, fv = (_fold_j(t, 1) for t in (jq, jk, jv))
    got = tref(*(torch.from_numpy(np.asarray(t, np.float32)).to(TDT[dtype])
                 for t in (fq, fk, fv)), causal=True)
    _close(got, jflash(fq, fk, fv, causal=True, interpret=True), tol)
    _close(got, jref(fq, fk, fv, causal=True), tol)


@pytest.mark.parametrize("S", [12, 33])
def test_non_causal_with_ragged_length_matches_the_oracle(S):
    """Non-causal, S not a multiple of any block: the port masks keys at
    or past S, so it equals ``attention_ref`` (2e-3, float32)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(S, 1, S, 4, 2, 16, "float32")
    got = tops.attend(tq, tk, tv, causal=False, block=8)
    want = jref(_fold_j(jq, 1), _fold_j(jk, 2), _fold_j(jv, 2), causal=False)
    _close(got.transpose(1, 2).reshape(4, S, 16), want, TOL["float32"])


def test_reference_attend_lets_padded_keys_into_the_non_causal_softmax():
    """States a fault of the reference: its ``ops.attend`` zero-pads K and
    V to the block, and without the causal mask the padded keys score 0
    and enter the softmax (B=1, S=12, H=2, K=1, hd=8, block 8 -> 16).  It
    misses ``attention_ref`` by far more than the bar; the port stays
    within 2e-3 of it."""
    B, S, H, KH, hd = 1, 12, 2, 1, 8
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, B, S, H, KH, hd, "float32")
    want = np.asarray(jref(_fold_j(jq, 1), _fold_j(jk, 2), _fold_j(jv, 2),
                           causal=False))
    ref_op = jops.attend(jq, jk, jv, causal=False, block=8, interpret=True)
    ref_err = np.abs(np.asarray(ref_op).transpose(0, 2, 1, 3)
                     .reshape(B * H, S, hd) - want).max()
    assert ref_err > 0.1, ref_err
    got = tops.attend(tq, tk, tv, causal=False, block=8)
    _close(got.transpose(1, 2).reshape(B * H, S, hd), want, TOL["float32"])
    # causal, the same shapes: the reference's op is right
    causal_ref = jops.attend(jq, jk, jv, causal=True, block=8, interpret=True)
    _close(tops.attend(tq, tk, tv, causal=True), causal_ref, TOL["float32"])


def test_block_changes_nothing_and_cpu_tensors_do_not_launch():
    """``block`` is the reference's argument and does not change the
    result; CPU tensors take the plain version and count no launch."""
    _, (tq, tk, tv) = _qkv(1, 2, 40, 4, 2, 16, "bfloat16")
    K.reset_launch_counts()
    outs = [tops.attend(tq, tk, tv, causal=True, block=b) for b in (8, 16,
                                                                    512)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], K.flash_attention(tq, tk, tv, causal=True))
    assert K.launch_counts() == {"flash_attention": 0}
    assert 128 in K.HEAD_DIMS
