"""Every shape the reference's kernels take: wide encoders, wide and deep
stacks, fan-in up to 16, rows past a block's shared memory, any head dim
up to 256.

The card's kernels once refused such operands for their size alone
(``check_activation_width``, ``MAX_LAYERS``, fan-in 8 in the float
kernels, the rows kernels' widths, four head dims); each plan function
now returns a path for every shape.  These CPU tests hold:

* the plain versions (what each wrapper runs for CPU tensors, and what
  the CUDA kernels are held to on the card) against the reference's
  Pallas kernels in interpret mode, at reduced versions of the shapes
  ``chip_smoke.py``'s ``limits`` phase runs at full size (W1a: a
  4096-threshold encoder; W1b: two hidden layers of 32,000 LUTs; W2: 784
  features; W3: twelve layers; W4: fan-in 10 and 12 here, 16 on the card
  only), exact: words, counts held in float32 and the argmax are
  integers;
* the plans at the full sizes, and that every shape the tiles took
  before keeps the plan it had (the plan functions as they stood before
  the global paths are copied below as ``_Old``);
* what still raises: a malformed operand, fan-in above 16, a head dim
  above 256;
* ``attention_ref`` at head dims 8, 32, 80 and 256 against the
  reference's ``attend`` in interpret mode (2e-3, float32, its bar).
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.autotune import FusedConfig as JConfig  # noqa: E402
from repro.kernels.flash_attn import ops as jattn  # noqa: E402
from repro.kernels.fused import ops as jfused  # noqa: E402
from repro.kernels.lut_eval import ops as jlut  # noqa: E402
from repro.kernels.popcount import ops as jpc  # noqa: E402
from repro.kernels.thermometer import ops as jth  # noqa: E402
from repro_torch.core import bitpack as tbp  # noqa: E402
from repro_torch.kernels._launch import align16  # noqa: E402
from repro_torch.kernels.autotune import FusedConfig  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as KA  # noqa: E402
from repro_torch.kernels.flash_attn import ops as tattn  # noqa: E402
from repro_torch.kernels.fused import kernel as K  # noqa: E402
from repro_torch.kernels.fused import ops as tfused  # noqa: E402
from repro_torch.kernels.fused import ref as R  # noqa: E402
from repro_torch.kernels.lut_eval import kernel as KL  # noqa: E402
from repro_torch.kernels.lut_eval import ops as tlut  # noqa: E402
from repro_torch.kernels.popcount import ops as tpc  # noqa: E402
from repro_torch.kernels.thermometer import ops as tth  # noqa: E402

SMS = 132
MAX = K.MAX_SMEM_BYTES

#: reduced versions of the limits phase's shapes: features, thresholds a
#: feature, LUTs a layer, fan-in, classes
REDUCED = {
    "W1a": dict(F=4, T=1024, luts=(160,), n=6, C=5),
    "W1b": dict(F=4, T=50, luts=(640, 640, 160), n=6, C=5),
    "W2": dict(F=196, T=8, luts=(320, 80), n=6, C=10),
    "W3": dict(F=4, T=20, luts=(160,) * 12, n=6, C=5),
    "W4n10": dict(F=4, T=20, luts=(60,), n=10, C=5),
    "W4n12": dict(F=4, T=20, luts=(60,), n=12, C=5),
}
#: the full sizes (chip_smoke.LIMITS)
FULL = {
    "W1a": dict(F=16, T=4096, luts=(2400,), n=6, C=5),
    "W1b": dict(F=16, T=200, luts=(32000, 32000, 2400), n=6, C=5),
    "W2": dict(F=784, T=16, luts=(8000, 1280), n=6, C=10),
    "W3": dict(F=16, T=200, luts=(2400,) * 12, n=6, C=5),
    "W4n10": dict(F=16, T=200, luts=(480,), n=10, C=5),
    "W4n16": dict(F=16, T=200, luts=(480,), n=16, C=5),
}
B = 9


def _model(name, seed=0):
    """x (B, F), ascending thresholds, per-layer wires and {0,1} tables."""
    s = REDUCED[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, s["F"])).astype(np.float32)
    th = np.sort(rng.uniform(-1, 1, (s["F"], s["T"])).astype(np.float32),
                 axis=1)
    maps, tabs, cand = [], [], s["F"] * s["T"]
    for m in s["luts"]:
        maps.append(rng.integers(0, cand, (m, s["n"])).astype(np.int32))
        tabs.append(rng.integers(0, 2, (m, 2 ** s["n"])).astype(np.int32))
        cand = m
    return x, th, maps, tabs, s["C"]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _equal(got, want):
    counts, idx = (np.asarray(a) for a in got)
    np.testing.assert_array_equal(counts, np.asarray(want[0]))
    np.testing.assert_array_equal(idx, np.asarray(want[1]))


@pytest.mark.parametrize("variant", ["packed", "batch-major"])
@pytest.mark.parametrize("name", list(REDUCED))
def test_fused_packed_plain_matches_reference(name, variant):
    """K2's and K1's plain versions (the port's ``make_forward_packed`` on
    CPU tensors) against the reference's in interpret mode: exact counts
    and argmax, any depth, width and fan-in."""
    x, th, maps, tabs, C = _model(name)
    got = tfused.make_forward_packed(
        torch.from_numpy(th), _t(maps), _t(tabs), C,
        config=FusedConfig(variant=variant, block_b=32))(torch.from_numpy(x))
    want = jfused.make_forward_packed(
        jnp.asarray(th), _j(maps), _j(tabs), C,
        config=JConfig(variant=variant, block_b=32),
        interpret=True)(jnp.asarray(x))
    _equal(got, want)


@pytest.mark.parametrize("name", list(REDUCED))
def test_staged_plain_matches_reference(name):
    """K3 -> K4 per layer -> K5 (plain) against the reference's packed
    ops in interpret mode: exact words after every layer, exact counts."""
    x, th, maps, tabs, C = _model(name, seed=1)
    got = tth.encode_packed(torch.from_numpy(x), torch.from_numpy(th))
    want = jth.encode_packed(jnp.asarray(x), jnp.asarray(th),
                             interpret=True)
    for mp, tb in zip(maps, tabs):
        got = tlut.evaluate_packed(got, torch.from_numpy(mp),
                                   torch.from_numpy(tb))
        want = jlut.evaluate_packed(want, jnp.asarray(mp), jnp.asarray(tb),
                                    interpret=True)
        assert got.num_bits == want.num_bits
        assert tbp.words_to_numpy(got.words).tobytes() == \
            np.asarray(want.words).tobytes()
    _equal(tpc.classify_packed(got, C),
           jpc.classify_packed(want, C, interpret=True))


@pytest.mark.parametrize("name", list(REDUCED))
def test_float_plain_matches_reference(name):
    """K7 -> K8 per layer -> K9 (plain) against the reference's float ops
    in interpret mode: exact {0,1} bits after every layer, exact counts."""
    x, th, maps, tabs, C = _model(name, seed=2)
    got = tth.encode(torch.from_numpy(x), torch.from_numpy(th))
    want = jth.encode(jnp.asarray(x), jnp.asarray(th), interpret=True)
    for mp, tb in zip(maps, tabs):
        got = tlut.evaluate(got, torch.from_numpy(mp), torch.from_numpy(tb))
        want = jlut.evaluate(want, jnp.asarray(mp), jnp.asarray(tb),
                             interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _equal(tpc.classify(got, C), jpc.classify(want, C, interpret=True))


@pytest.mark.parametrize("name", [n for n, s in REDUCED.items()
                                  if len(s["luts"]) == 1])
def test_float_fused_plain_matches_reference(name):
    """K6's plain version (one layer) against the reference's ``forward``
    in interpret mode, at the wide encoder and at fan-in 10 and 12."""
    x, th, maps, tabs, C = _model(name, seed=3)
    got = tfused.forward(torch.from_numpy(x), torch.from_numpy(th),
                         torch.from_numpy(maps[0]), torch.from_numpy(tabs[0]),
                         C)
    want = jfused.forward(jnp.asarray(x), jnp.asarray(th),
                          jnp.asarray(maps[0]), jnp.asarray(tabs[0]), C,
                          interpret=True)
    _equal(got, want)


def _layers_meta(luts, n):
    return R.LayerStack.build(
        [torch.zeros((m, n), dtype=torch.long) for m in luts],
        [torch.zeros((m, 2 ** n), dtype=torch.long) for m in luts],
        10 ** 6, "cpu")


def test_a_deep_stack_keeps_its_meta_on_its_device():
    """A stack of any depth: ``meta_dev`` is the host's meta rows, on the
    stack's device, read by the packed kernels past ``INLINE_LAYERS``."""
    stack = _layers_meta((64,) * 13, 2)
    assert stack.num_layers == 13 > K.INLINE_LAYERS
    assert stack.meta_dev.dtype == torch.int32
    np.testing.assert_array_equal(stack.meta_dev.numpy(), stack.meta)
    assert not hasattr(R, "MAX_LAYERS")


@pytest.mark.parametrize("name,packed,batch_major", [
    ("W1a", "global", "shared"), ("W1b", "global", "global"),
    ("W2", "global", "global"), ("W3", "shared", "shared"),
    ("W4n10", "shared", "shared"), ("W4n16", "shared", "shared")])
def test_full_size_shapes_take_a_path_on_k1_and_k2(name, packed,
                                                   batch_major):
    """At full size the activation plan puts W1a's 2,048 encoded words
    (K2), W1b's two 1,000-word hidden layers and W2's 784 features in the
    global scratch; the rest stay in shared memory (W3's twelve layers
    read the model from global memory past ``INLINE_LAYERS``).  The
    scratch is a part of 32 x (F + buffers x width) words for each block
    (the blocks are the source's count, held on the card)."""
    s = FULL[name]
    for variant, want in (("packed", packed), ("batch-major", batch_major)):
        T = s["T"] if variant == "packed" else 0
        path = K.check_activation_width(variant, s["F"], T, s["luts"],
                                        s["C"])
        assert path == want, (variant, path)
        widths = [-(-m // 32) for m in s["luts"][:-1]]
        if variant == "packed":
            widths.append(-(-s["F"] * s["T"] // 32))
        assert K.scratch_words(variant, s["F"], T, s["luts"], s["C"]) == \
            32 * (s["F"] + min(len(widths), 2) * max(widths, default=0))


def test_full_size_float_and_packed_layer_plans():
    """K6 at fan-in 10 and 16 takes its global path (tables from global
    memory, the tile's features staged), as does any explicit block_m no
    block holds; K8 at W1a's 65,536-bit rows and at fan-in 10 and 16
    takes the wide kernel; K4 at rows of 8,192 words reads them from
    global memory, at fan-in 16 on 100-word rows the rows kernel."""
    for n in (10, 16):
        for Bn in (1, 33, 1000, 4096):
            plan = K.plan_fused_dwn(Bn, 16, 480, n, 5, 32, None, SMS)
            assert plan.path == "global" and plan.smem_bytes == 16 * 128
            assert plan.slice_ranges()[-1][1] == plan.chunks == 15
            assert plan.slices * plan.cs >= plan.chunks
            assert KL.plan_lut_eval(Bn, 3200, 480, SMS, n).path == "global"
    assert K.plan_fused_dwn(8, 60_000, 480, 6, 5, 32, None,
                            SMS).smem_bytes == 0
    plan = KL.plan_lut_eval(256, 65_536, 2400, SMS, 6)
    assert (plan.path, plan.rows, plan.smem_bytes) == ("global", 4, 0)
    assert KL.plan_lut_eval_packed(4096, 8192, 2400, 6, SMS) == \
        KL.PackedPlan("global", 1, 75, 0)
    assert KL.plan_lut_eval_packed(4096, 100, 480, 16, SMS).path == "rows"


@pytest.mark.parametrize("hd,inst,design", [
    (8, 16, "mma"), (16, 16, "mma"), (32, 32, "mma"), (40, 64, "tma"),
    (50, 64, "mma"), (64, 64, "tma"), (80, 96, "tma"), (96, 96, "tma"),
    (100, 256, "mma"), (128, 128, "tma"), (200, 256, "mma"),
    (256, 256, "mma")])
def test_every_head_dim_to_256_has_an_instance(hd, inst, design):
    """K10 runs each head dim on the smallest instance at or above it;
    TMA reads only multiples of 8, so other head dims run the mma.sync
    design (its hd-64 and hd-96 instances, or hd 256 above 96)."""
    assert KA.instance_for(hd) == (inst, design)
    assert inst in KA.HEAD_DIMS


def test_what_still_raises():
    """Malformed operands, fan-in above 16 and head dims above 256."""
    with pytest.raises(ValueError, match="fan-in 17"):
        _layers_meta((32,), 17)
    with pytest.raises(ValueError, match="fan-in 17"):
        R.first_layer_wires(torch.zeros((4, 8)),
                            torch.zeros((32, 17), dtype=torch.long),
                            torch.zeros((32, 2 ** 17), dtype=torch.long))
    with pytest.raises(ValueError, match="tables"):
        R.LayerStack.build([torch.zeros((32, 2), dtype=torch.long)],
                           [torch.zeros((32, 8), dtype=torch.long)], 64,
                           "cpu")
    for hd in (0, 257, 512):
        with pytest.raises(ValueError, match="head_dim"):
            KA.instance_for(hd)
    assert K.FUSED_DWN_MAX_FAN_IN == KL.MAX_FAN_IN == R.MAX_FAN_IN == 16
    # any class count: past 1,815 a tile's counts join the scratch
    assert K.check_activation_width("packed", 16, 200, (64, 2 ** 12),
                                    2 ** 11) == "global"
    assert K.scratch_words("packed", 16, 200, (64, 2 ** 12), 2 ** 11) == \
        32 * (16 + 2 * 100 + 2 ** 11)
    assert K.scratch_words("packed", 16, 200, (64, 2 ** 12), 1815) == \
        32 * (16 + 2 * 100)
    assert KA.MAX_HEAD_DIM == 256


# --- the former plan functions (shapes the tiles took keep their plan)


class _Old:
    """``plan_fused_dwn`` / ``_plan_rows`` (fused/kernel.py) and
    ``plan_lut_eval_packed`` / ``plan_lut_eval`` (lut_eval/kernel.py) as
    they were before the global paths, which raised where these now
    return one."""

    @staticmethod
    def fused_dwn(B, F, m, n, C, block_b, block_m, sms):
        tiles_smem = K._tiles_smem_bytes
        lut = 4 * (2 ** n + 2 * n)
        if block_m is not None and min(block_m, m) * lut > MAX:
            raise ValueError("shared memory")
        g = m // C
        cpc = -(-g // K.CHUNK_LUTS)
        chunks = C * cpc
        if tiles_smem(F, n, 1, 0) > MAX // 2:
            lut, row = 2 ** n + 2 * n, F + 32 * C
            bm = (max(1, min(m, (MAX // 4 - row) // lut))
                  if block_m is None else min(block_m, m))
            bb = max(1, min(block_b, B, (MAX // 4 - bm * lut) // row))
            smem = K._rows_smem_bytes(F, C, n, bb, bm)
            if smem > MAX:
                raise ValueError("shared memory")
            return K.FloatPlan("rows", bb, 1, 0, 0, 0, chunks, bm, smem)
        fit = (MAX - tiles_smem(F, n, 1, 0)) // tiles_smem(0, n, 0, 1)
        cap = fit if block_m is None else min(fit, block_m // K.CHUNK_LUTS)
        cap = max(1, min(cap, chunks))
        k, ppc = (cap // cpc, 1) if 0 < cpc <= cap else (1, -(-cpc // cap))
        ucs, _, cs, _ = K._slices(cpc, chunks, k, ppc)
        groups = min(-(-block_b // 32), -(-B // 32))
        while groups > 1 and tiles_smem(F, n, groups, cs) > MAX:
            groups -= 1
        tiles = -(-B // (32 * groups))
        want = max(1, (sms + tiles // 2) // tiles)
        shape = K._slices(cpc, chunks, k, ppc)
        while shape[3] < want and shape[2] > 1:
            if k > 1:
                k -= 1
            else:
                ppc += 1
            shape = K._slices(cpc, chunks, k, ppc)
        ucs, ppc, cs, slices = shape
        return K.FloatPlan("tiles", 32 * groups, slices, ucs, ppc, cs,
                           chunks, cs * K.CHUNK_LUTS,
                           tiles_smem(F, n, groups, cs))

    @staticmethod
    def lut_eval_packed(B, W_in, m, n, sms):
        smem_of = KL._tiles_smem_bytes
        W_out = max(1, m // 32)
        if smem_of(W_in, n, 0) > MAX // 2 or smem_of(W_in, n, 1) > MAX:
            smem = KL.THREADS // 32 * W_in * 4
            if smem > MAX:
                raise ValueError("shared memory")
            return KL.PackedPlan("rows", 1, W_out, smem)
        lo, hi = 1, W_out + 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if smem_of(W_in, n, mid) <= MAX else (lo, mid)
        tiles = -(-B // 32)
        slices = max(-(-W_out // lo),
                     min(W_out, max(1, (sms + tiles // 2) // tiles)))
        ws = -(-W_out // slices)
        return KL.PackedPlan("tiles", -(-W_out // ws), ws,
                             smem_of(W_in, n, ws))

    @staticmethod
    def lut_eval(B, C, m, sms):
        smem = align16(16 * ((C + 3) // 4 * 4) * 4)
        passes = -(-max(m, 1) // 128)
        if smem > MAX:
            rows = min(8, MAX // (4 * max(C, 1)))
            if rows < 1:
                raise ValueError("shared memory")
            return KL.FloatPlan("rows", 1, passes, rows, rows * C * 4)
        tiles = -(-B // 16)
        slices = min(passes, max(1, (sms + tiles // 2) // tiles))
        per = -(-passes // slices)
        return KL.FloatPlan("tiles", -(-passes // per), per, 16, smem)


def _same_or_new(old, new, new_paths):
    """The former plan where it had one; else one of the new paths."""
    try:
        want = old()
    except ValueError:
        assert new().path in new_paths
        return False
    assert dataclasses.astuple(new()) == dataclasses.astuple(want)
    return True


def test_plans_of_shapes_the_tiles_took_are_unchanged():
    """Over grids of batches, widths, fan-ins 1-8 and tile sizes, every
    K6, K8 and K4 launch the former plans took keeps that plan field for
    field, and every one they refused now takes the global path; K1 and K2
    keep shared memory exactly where it fitted before; K10 runs its four
    former head dims on their own instances."""
    kept = refused = 0
    for Bn, F, n, bb, bm, m in itertools.product(
            (1, 33, 1000, 4096), (1, 16, 454, 455, 5000, 60_000),
            range(1, 9), (1, 32, 4096), (None, 32, 128, 900), (64, 2400)):
        ok = _same_or_new(
            lambda: _Old.fused_dwn(Bn, F, m, n, 5, bb, bm, SMS),
            lambda: K.plan_fused_dwn(Bn, F, m, n, 5, bb, bm, SMS),
            ("global", "rows"))
        kept, refused = kept + ok, refused + (not ok)
    for Bn, W_in, n, m in itertools.product(
            (1, 33, 4096), (1, 100, 454, 455, 7264, 7265, 20_000),
            (1, 6, 10, 16), (32, 2400)):
        _same_or_new(lambda: _Old.lut_eval_packed(Bn, W_in, m, n, SMS),
                     lambda: KL.plan_lut_eval_packed(Bn, W_in, m, n, SMS),
                     ("global",))
    for Bn, C, m, n in itertools.product(
            (1, 33, 4096), (1, 3632, 3633, 58_112, 58_113, 65_536),
            (64, 2400), range(1, 9)):
        _same_or_new(lambda: _Old.lut_eval(Bn, C, m, SMS),
                     lambda: KL.plan_lut_eval(Bn, C, m, SMS, n),
                     ("global",))
    assert kept and refused
    for variant, F, T, luts in itertools.product(
            ("packed", "batch-major"), (16, 196, 784), (16, 200, 4096),
            ((2400,), (8000, 1280), (32000, 2400), (3200,) * 3)):
        width = [-(-m // 32) for m in luts[:-1]]
        if variant == "packed":
            width.append(-(-F * T // 32))
        need = K.min_tile_smem(F, 5, max(width, default=0),
                               min(len(width), 2))
        path = K.check_activation_width(variant, F, T, luts, 5)
        assert path == ("shared" if need <= MAX else "global")
    for hd in (16, 64, 96, 128):
        assert KA.instance_for(hd) == (hd, "mma" if hd == 16 else "tma")


def _qkv(seed, Bq, S, H, KH, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((Bq, S, h, hd)).astype(np.float32) * s
            for h, s in ((H, 0.5), (KH, 1.0), (KH, 1.0))]


@pytest.mark.parametrize("S", [1, 33, 64])
@pytest.mark.parametrize("hd", [8, 32, 80, 256])
def test_attention_ref_at_new_head_dims_matches_reference(hd, S):
    """The plain version K10 is held to on the card, at head dims 8, 32,
    80 and 256 (GQA 4:2, causal), against the reference's ``attend`` in
    interpret mode, within its 2e-3 bar in float32; the scale is the head
    dim's own ``hd ** -0.5``."""
    arrs = _qkv(hd + S, 2, S, 4, 2, hd)
    got = tattn.attend(*_t(arrs), causal=True)
    want = jattn.attend(*_j(arrs), causal=True, block=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
