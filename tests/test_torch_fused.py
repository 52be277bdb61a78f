"""The fused DWN kernels: plain versions vs the reference's Pallas kernels.

CPU tests hold ``repro_torch.kernels.fused.ops.make_forward_packed`` (whose
wrappers run the plain versions for CPU tensors) against
``repro.kernels.fused.ops.make_forward_packed(..., interpret=True)`` on the
same numpy operands, for both variants and several ``block_b``.  The
CUDA kernels are held to these plain versions on the card by
``test_torch_gpu.py``.  Every comparison is exact: counts are integers held
in float32 and the argmax is an integer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.autotune import FusedConfig as JConfig  # noqa: E402
from repro.kernels.fused import ops as jops  # noqa: E402
from repro_torch.kernels.autotune import FusedConfig  # noqa: E402
from repro_torch.kernels.fused import kernel as K  # noqa: E402
from repro_torch.kernels.fused import ops as tops  # noqa: E402
from repro_torch.kernels.fused import ref as R  # noqa: E402


def _model(seed, F, T, counts, n=6, B=37, pen_frac=None):
    """Numpy operands: x, ascending thresholds, per-layer wires/tables."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, F)).astype(np.float32)
    th = np.sort(rng.uniform(-1, 1, (F, T)).astype(np.float32), axis=1)
    if pen_frac is not None:          # PEN: many exact x == th ties
        x = np.round(x * 2 ** pen_frac) / 2 ** pen_frac
        th = np.round(th * 2 ** pen_frac) / 2 ** pen_frac
    maps, tabs, cand = [], [], F * T
    for m in counts:
        maps.append(rng.integers(0, cand, (m, n)).astype(np.int32))
        tabs.append(rng.integers(0, 2, (m, 2 ** n)).astype(np.int32))
        cand = m
    return x, th, maps, tabs


def _port(x, th, maps, tabs, C, variant, block_b, device="cpu"):
    fn = tops.make_forward_packed(
        torch.from_numpy(th).to(device),
        [torch.from_numpy(a).to(device) for a in maps],
        [torch.from_numpy(a).to(device) for a in tabs], C,
        config=FusedConfig(variant=variant, block_b=block_b))
    counts, idx = fn(torch.from_numpy(x).to(device))
    assert counts.dtype == torch.float32 and idx.dtype == torch.int32
    return counts.cpu().numpy(), idx.cpu().numpy()


def _reference(x, th, maps, tabs, C, variant, block_b):
    fn = jops.make_forward_packed(
        jnp.asarray(th), [jnp.asarray(a) for a in maps],
        [jnp.asarray(a) for a in tabs], C,
        config=JConfig(variant=variant, block_b=block_b), interpret=True)
    counts, idx = fn(jnp.asarray(x))
    return np.asarray(counts), np.asarray(idx)


CASES = {
    # name: (seed, F, T, lut_counts, B, pen_frac, fan-in); no B is a
    # multiple of 32
    "sm-50": (11, 16, 200, (50,), 37, None, 6),
    "md-360-pen": (12, 16, 200, (360,), 21, 8, 6),
    "stack-120-50": (13, 16, 200, (120, 50), 43, None, 6),
    "fan8-stack-64-40": (14, 16, 20, (64, 40), 33, None, 8),
    "stack-120-64-50": (15, 16, 200, (120, 64, 50), 45, None, 6),
}


@pytest.mark.parametrize("variant", ["packed", "batch-major"])
@pytest.mark.parametrize("case,block_b", [("sm-50", 8), ("sm-50", 256),
                                          ("md-360-pen", 16),
                                          ("stack-120-50", 16),
                                          ("fan8-stack-64-40", 32),
                                          ("stack-120-64-50", 7)])
def test_plain_matches_reference_kernel(variant, case, block_b):
    """Exact: the plain version of each kernel == the reference's Pallas
    kernel (interpret mode) on the same operands, counts and argmax."""
    seed, F, T, counts, B, frac, n = CASES[case]
    x, th, maps, tabs = _model(seed, F, T, counts, n=n, B=B, pen_frac=frac)
    ref = _reference(x, th, maps, tabs, 5, variant, block_b)
    got = _port(x, th, maps, tabs, 5, variant, block_b)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_plain_handles_ragged_thermometer_words():
    """Exact: F*T = 65 (not a multiple of 32).  The reference serves it
    through its jnp oracle; the port's packed kernel takes the ragged last
    word with zero pad bits.  Both variants agree with it."""
    x, th, maps, tabs = _model(5, 5, 13, (40,), n=4, B=19)
    ref = _reference(x, th, maps, tabs, 5, "packed", 256)
    for variant in ("packed", "batch-major"):
        got = _port(x, th, maps, tabs, 5, variant, 8)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_plain_argmax_ties_to_lower_class_and_empty_batch():
    """Exact: all-equal counts (an all-zero model) give class 0; a batch of
    zero rows gives empty outputs."""
    x, th, maps, tabs = _model(1, 16, 200, (50,), B=9)
    tabs = [np.zeros_like(t) for t in tabs]
    for variant in ("packed", "batch-major"):
        counts, idx = _port(x, th, maps, tabs, 5, variant, 8)
        assert not counts.any() and not idx.any()
        counts, idx = _port(x[:0], th, maps, tabs, 5, variant, 8)
        assert counts.shape == (0, 5) and idx.shape == (0,)


def test_cpu_tensors_take_the_plain_version_without_launching():
    """On CPU tensors the wrappers run the plain version and count no
    launch (the zero kernel's wrapper runs ``Tensor.zero_``); a tensor on
    another device type is refused."""
    x, th, maps, tabs = _model(2, 16, 200, (50,), B=4)
    K.reset_launch_counts()
    _port(x, th, maps, tabs, 5, "packed", 8)
    _port(x, th, maps, tabs, 5, "batch-major", 8)
    junk = torch.arange(1, 40, dtype=torch.int32)
    assert K.fused_dwn_zero(junk) is junk and not junk.any()
    assert K.launch_counts() == {"fused_dwn": 0, "fused_dwn_packed": 0,
                                 "fused_dwn_batch_major": 0,
                                 "fused_dwn_zero": 0}
    ops = tops.prepare_operands(torch.from_numpy(th),
                                [torch.from_numpy(maps[0])],
                                [torch.from_numpy(tabs[0])], 5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.fused_dwn_packed(torch.zeros((4, 16), device="meta"), *ops)


def test_operand_prep_rejects_bad_wires_and_tables():
    """Out-of-range wires and malformed tables raise instead of reading
    out of bounds in the kernel."""
    _, th, maps, tabs = _model(3, 16, 200, (50,))
    th_t = torch.from_numpy(th)
    bad = maps[0].copy()
    bad[3, 2] = 16 * 200
    for variant in ("packed", "batch-major"):
        with pytest.raises(ValueError, match="mapping indices"):
            tops.prepare_operands(th_t, [torch.from_numpy(bad)],
                                  [torch.from_numpy(tabs[0])], 5, variant)
        with pytest.raises(ValueError, match="tables have shape"):
            tops.prepare_operands(th_t, [torch.from_numpy(maps[0])],
                                  [torch.from_numpy(tabs[0][:, :32])], 5,
                                  variant)


def test_layer_stack_layout():
    """The flat layer descriptor the kernels read: layers padded to 32
    LUTs, one int32 bit index per wire, offsets, and one-bit-per-entry
    table words; ``layers()`` splits each wire into word and bit for the
    LUT-layer kernel."""
    _, th, maps, tabs = _model(4, 16, 200, (120, 50))
    stack = R.LayerStack.build([torch.from_numpy(a) for a in maps],
                               [torch.from_numpy(a) for a in tabs],
                               16 * 200, "cpu")
    assert stack.shapes == ((128, 6), (64, 6))
    assert stack.meta.tolist() == [[128, 6, 0, 0, 2],
                                   [64, 6, 128 * 6, 128 * 2, 2]]
    np.testing.assert_array_equal(
        stack.wires[:120 * 6].numpy(), maps[0].reshape(-1))
    assert not stack.wires[120 * 6:128 * 6].any()
    (w0, b0, t0), (w1, b1, t1) = stack.layers()
    assert w0.dtype == b0.dtype == torch.int32
    np.testing.assert_array_equal((w0[:120] * 32 + b0[:120]).numpy(),
                                  maps[0])
    assert not t0[120:].any() and not t1[50:].any()
    from repro.core.bitpack import pack_bits_np
    np.testing.assert_array_equal(
        t1[:50].numpy().view(np.uint32), pack_bits_np(tabs[1]))


def test_first_layer_wires_layout():
    """The batch-major kernel's first layer: int16 feature index and the
    float32 threshold of every wire, padded to 32 LUTs with wires that
    read 0 (+inf thresholds) and all-zero tables; more features than 16
    bits index are refused."""
    _, th, maps, tabs = _model(6, 16, 200, (50,))
    wire_f, wire_th, tab0 = R.first_layer_wires(
        torch.from_numpy(th), torch.from_numpy(maps[0]),
        torch.from_numpy(tabs[0]))
    assert wire_f.dtype == torch.int16 and wire_f.shape == (64, 6)
    np.testing.assert_array_equal(wire_f[:50].numpy(), maps[0] // 200)
    np.testing.assert_array_equal(wire_th[:50].numpy(),
                                  th.reshape(-1)[maps[0]])
    assert torch.isinf(wire_th[50:]).all() and not tab0[50:].any()
    wide = torch.zeros((R.MAX_DIRECT_FEATURES + 1, 1))
    with pytest.raises(ValueError, match="features"):
        R.first_layer_wires(wide, torch.zeros((32, 2), dtype=torch.long),
                            torch.zeros((32, 4), dtype=torch.long))



@pytest.mark.parametrize("variant,F,T,luts,fits", [
    # lg-2400 and a deep stack of wide layers fit a tile of 32 samples
    ("packed", 16, 200, (2400,), True),
    ("batch-major", 16, 200, (2400,), True),
    ("packed", 16, 200, (3200, 3200, 3200, 2400), True),
    ("batch-major", 16, 200, (3200, 3200, 3200, 2400), True),
    # the packed encode's F*T bits are activations; batch-major has none
    # in a one-layer model, only its features
    ("packed", 16, 4000, (2400,), False),
    ("batch-major", 16, 4000, (2400,), True),
    # one activation buffer fits where two (a third layer) do not
    ("batch-major", 16, 200, (30000, 2400), True),
    ("batch-major", 16, 200, (30000, 30000, 2400), False),
    ("batch-major", 1000, 200, (2400,), False),
])
def test_activation_width_check(variant, F, T, luts, fits):
    """The wrappers refuse, before any launch, a model whose features and
    widest activations for one tile of 32 samples do not fit a block's
    shared memory (the layout the launch takes with the model left in
    global memory); the table sizes and fan-ins never make them refuse."""
    words = [(m + 31) // 32 for m in luts[:-1]]
    if variant == "packed":
        words.append((F * T + 31) // 32)
    need = K.min_tile_smem(F, 5, max(words, default=0), min(len(words), 2))
    assert (need <= K.MAX_SMEM_BYTES) == fits
    if fits:
        K.check_activation_width(variant, F, T, luts, 5)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            K.check_activation_width(variant, F, T, luts, 5)
