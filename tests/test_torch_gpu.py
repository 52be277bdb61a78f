"""On a CUDA card: each CUDA kernel against its plain version, the staged
packed and float ops against the fused kernels, the serving engine
through the kernels, and the flash-attention kernel on its own and in the
prefill of a reduced qwen3-8b.

These tests import torch and not JAX (the card's machine has no JAX); the
plain versions they compare with are held to the reference's Pallas
kernels by ``test_torch_fused.py``, ``test_torch_staged.py`` and
``test_torch_float.py``.  Each test decides inside itself whether a card
is present and skips without one.  Every comparison on {0,1} operands is
exact: counts are integers held in float32 and the argmax is an integer.
Soft bits in the float LUT layer are held within 1e-5 and float tables in
the float fused kernel within 1e-4 (nvcc contracts a*b+c into FMA; eager
PyTorch rounds twice).  Flash attention (bf16 in and out, P rounded to
bf16 before its product with V) is held to its float32 plain version
within 2e-2, absolute and relative, the reference's bf16 bar
(``tests/test_flash_kernel.py``), and within 1e-2 of each query row's
largest value, a bar that a dropped key tile or a missing rescale of the
output fails where the elementwise one does not.

Run on a card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bitpack as tbp  # noqa: E402
from repro_torch.kernels.autotune import FusedConfig  # noqa: E402
from repro_torch.kernels.fused import kernel as K  # noqa: E402
from repro_torch.kernels.fused import ops as tops  # noqa: E402
from repro_torch.kernels.fused import ref as R  # noqa: E402
from repro_torch.kernels.lut_eval import kernel as KL  # noqa: E402
from repro_torch.kernels.lut_eval import ops as OL  # noqa: E402
from repro_torch.kernels.lut_eval import ref as RL  # noqa: E402
from repro_torch.kernels.popcount import kernel as KP  # noqa: E402
from repro_torch.kernels.popcount import ops as OP  # noqa: E402
from repro_torch.kernels.popcount import ref as RP  # noqa: E402
from repro_torch.kernels.thermometer import kernel as KT  # noqa: E402
from repro_torch.kernels.thermometer import ops as OT  # noqa: E402
from repro_torch.kernels.thermometer import ref as RT  # noqa: E402

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")


def _model(seed, F, T, counts, n=6, B=1000, pen_frac=None):
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


def _fused_kernel(variant):
    """(kernel, plain version, launch-count name) of a packed variant."""
    kern, plain = {
        "packed": (K.fused_dwn_packed, R.fused_dwn_packed_plain),
        "batch-major": (K.fused_dwn_batch_major,
                        R.fused_dwn_batch_major_plain)}[variant]
    return kern, plain, "fused_dwn_" + variant.replace("-", "_")


@pytest.mark.parametrize("variant", ["packed", "batch-major"])
def test_cuda_kernel_matches_plain(variant):
    """Exact: lg-2400 width, a 2-layer stack, a fan-in-8 stack (tables
    past 64 entries), PEN ties, a ragged F*T, ragged B (chip_smoke's
    4097, 4096, 1000, 33, 31 and 1, and 0) and several block_b; one launch
    counted per non-empty call."""
    _need_card()
    kern, plain, name = _fused_kernel(variant)
    cases = [(16, 200, (2400,), 6, None), (16, 200, (120, 50), 6, None),
             (16, 200, (256, 60), 8, None), (16, 200, (360,), 6, 8),
             (5, 13, (40,), 6, None)]
    for i, (F, T, counts, n, frac) in enumerate(cases):
        x, th, maps, tabs = _model(i, F, T, counts, n=n, B=4097,
                                   pen_frac=frac)
        ops = tops.prepare_operands(
            torch.from_numpy(th).cuda(),
            [torch.from_numpy(a).cuda() for a in maps],
            [torch.from_numpy(a).cuda() for a in tabs], 5, variant)
        for B in (4097, 4096, 1000, 33, 31, 1, 0):
            xd = torch.from_numpy(x[:B]).cuda()
            ref_c, ref_i = plain(xd, *ops)
            for block_b in (1, 7, 32, 256, 4096):
                before = K.launch_counts()[name]
                got_c, got_i = kern(xd, *ops, block_b=block_b)
                torch.cuda.synchronize()
                assert torch.equal(got_c, ref_c), (i, B, block_b)
                assert torch.equal(got_i, ref_i), (i, B, block_b)
                assert K.launch_counts()[name] == before + (B > 0)


@pytest.mark.parametrize("variant", ["packed", "batch-major"])
def test_cuda_graph_replay_equals_eager_call(variant):
    """Exact: K2 and K1 captured in a CUDA graph at lg-2400 width and the
    served buckets (one tile split over blocks at B=1 and 64, whole tiles
    at 4096), replayed on new inputs written into the captured ones, equal
    the eager call on the same inputs."""
    _need_card()
    kern, _, _ = _fused_kernel(variant)
    x, th, maps, tabs = _model(40, 16, 200, (2400,), B=8192)
    ops = tops.prepare_operands(
        torch.from_numpy(th).cuda(), [torch.from_numpy(maps[0]).cuda()],
        [torch.from_numpy(tabs[0]).cuda()], 5, variant)
    for B in (1, 64, 1024, 4096):
        xd = torch.from_numpy(x[:B]).cuda()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kern(xd, *ops)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got_c, got_i = kern(xd, *ops)
        for rows in (x[:B], x[B:2 * B]):
            xd.copy_(torch.from_numpy(rows))
            graph.replay()
            want_c, want_i = kern(xd, *ops)
            torch.cuda.synchronize()
            assert torch.equal(got_c, want_c) and torch.equal(got_i, want_i)


def test_cuda_tile_rounds_block_b_and_fits_shared_memory():
    """A tile is block_b rounded up to a multiple of 32, no more than B
    fills, and cut to what fits a block's shared memory beside the model
    (lg-2400: 4096 does not fit whole).  Models larger than a block's
    shared memory are served, not refused: 2050 LUTs of fan-in 10 split
    their last layer over blocks, fan-in 16 (one 32-LUT word of tables is
    256 KB) reads the model from global memory; both equal the plain
    version, and the zero kernel is counted when a launch splits its
    tiles.  Activations too wide for a tile raise before any launch."""
    _need_card()
    x, th, maps, tabs = _model(50, 16, 200, (2400,), B=4096)
    xd = torch.from_numpy(x).cuda()
    for variant in ("packed", "batch-major"):
        kern, _, _ = _fused_kernel(variant)
        ops = tops.prepare_operands(
            torch.from_numpy(th).cuda(), [torch.from_numpy(maps[0]).cuda()],
            [torch.from_numpy(tabs[0]).cuda()], 5, variant)
        for B, block_b, rows in ((64, 1, 32), (64, 7, 32), (64, 33, 64),
                                 (40, 4096, 64)):
            kern(xd[:B], *ops, block_b=block_b)
            assert K.last_launch()["tile_rows"] == rows, (B, block_b)
        kern(xd, *ops, block_b=4096)
        lay = K.last_launch()
        assert lay["staged"] and 32 <= lay["tile_rows"] < 4096
        assert lay["tile_rows"] % 32 == 0
        assert 0 < lay["smem_bytes"] <= K.MAX_SMEM_BYTES
    for seed, counts, n, staged in ((51, (2050,), 10, True),
                                    (52, (40,), 16, False)):
        x, th, maps, tabs = _model(seed, 16, 200, counts, n=n, B=4096)
        xd = torch.from_numpy(x).cuda()
        for variant in ("packed", "batch-major"):
            kern, plain, _ = _fused_kernel(variant)
            ops = tops.prepare_operands(
                torch.from_numpy(th).cuda(),
                [torch.from_numpy(maps[0]).cuda()],
                [torch.from_numpy(tabs[0]).cuda()], 5, variant)
            for B in (4096, 33):
                before = K.launch_counts()["fused_dwn_zero"]
                got_c, got_i = kern(xd[:B], *ops)
                lay = K.last_launch()
                ref_c, ref_i = plain(xd[:B], *ops)
                assert torch.equal(got_c, ref_c), (counts, variant, B)
                assert torch.equal(got_i, ref_i), (counts, variant, B)
                assert lay["staged"] == staged, lay
                assert lay["slices"] > 1 or not staged or B < 4096, lay
                assert lay["zeroed"] == (lay["slices"] > 1)
                assert K.launch_counts()["fused_dwn_zero"] == \
                    before + lay["zeroed"]
    x, th, maps, tabs = _model(53, 16, 4000, (100,), B=8)
    with pytest.raises(ValueError, match="shared memory"):
        tops.prepare_operands(
            torch.from_numpy(th).cuda(), [torch.from_numpy(maps[0]).cuda()],
            [torch.from_numpy(tabs[0]).cuda()], 5)


def test_cuda_zero_kernel_zeroes_and_counts():
    """The zero kernel on its own zeroes every int of a buffer of garbage
    and counts one launch; it refuses a tensor of 8-byte elements."""
    _need_card()
    buf = torch.randint(1, 2 ** 30, (4097 * 5 + 129,), dtype=torch.int32,
                        device="cuda")
    before = K.launch_counts()["fused_dwn_zero"]
    K.fused_dwn_zero(buf)
    torch.cuda.synchronize()
    assert not buf.any()
    assert K.launch_counts()["fused_dwn_zero"] == before + 1
    with pytest.raises(ValueError, match="4-byte"):
        K.fused_dwn_zero(torch.ones(8, dtype=torch.int64, device="cuda"))


def test_cuda_wrapper_refuses_bad_operands():
    """On the card a wrapper raises on operands it cannot take; it never
    falls back to the plain version."""
    _need_card()
    x, th, maps, tabs = _model(9, 16, 200, (50,), B=8)
    ops = tops.prepare_operands(torch.from_numpy(th).cuda(),
                                [torch.from_numpy(maps[0]).cuda()],
                                [torch.from_numpy(tabs[0]).cuda()], 5)
    xd = torch.from_numpy(x).cuda()
    with pytest.raises(ValueError, match="float32"):
        K.fused_dwn_packed(xd.double(), *ops)
    with pytest.raises(ValueError, match="is on"):
        K.fused_dwn_packed(xd, ops[0].cpu(), *ops[1:])
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_dwn_packed(xd.t().contiguous().t(), *ops)


def test_engine_serves_through_both_kernels_on_card():
    """Exact: the engine on the card equals the float oracle per request,
    with the default (packed) kernel and with batch-major per bucket; the
    launch counters show which kernel carried each pass."""
    _need_card()
    from repro_torch.serving import ServingEngine
    eng = ServingEngine("dwn-jsc-md", max_bucket=256, n_train=2000)
    assert eng.bit_exact == {"fused-packed": True, "packed-eager": True}
    oracle = eng.backends["float-oracle"]
    for variant, name in (("packed", "fused_dwn_packed"),
                          ("batch-major", "fused_dwn_batch_major")):
        for b in eng.scheduler.buckets:
            eng.model.tuned_configs[b] = FusedConfig(variant, block_b=8)
        K.reset_launch_counts()
        for size in (1, 100, 256, 300):
            eng.submit(eng.make_request(size, seed=size))
        done = eng.drain()
        assert K.launch_counts()[name] >= 4
        for r in done:
            xd = torch.from_numpy(np.ascontiguousarray(r.payload)).cuda()
            c, p = (t.cpu().numpy() for t in oracle(xd))
            np.testing.assert_array_equal(r.result[0], c)
            np.testing.assert_array_equal(r.result[1], p)


# (F, T, lut_counts, PEN fraction bits): lg width, a 2-layer stack, PEN
# ties, ragged thermometer words (F*T = 21 and 65)
STAGE_CASES = [(16, 200, (2400,), None), (16, 200, (120, 50), None),
               (16, 200, (360,), 8), (3, 7, (40,), None),
               (5, 13, (40,), None)]


PACKED_STAGES = ("thermometer_encode_packed", "lut_eval_packed",
                 "popcount_classify_packed")


def _stage_counts(names=PACKED_STAGES):
    every = {**KT.launch_counts(), **KL.launch_counts(),
             **KP.launch_counts()}
    return {name: every[name] for name in names}


def test_cuda_stage_kernels_match_plain():
    """Exact: K3, K4 (every layer) and K5 each equal their plain version
    on the same card inputs, for ragged B (incl. 1 and 0); one launch
    counted per non-empty call; words are int32 bit patterns."""
    _need_card()
    for i, (F, T, counts, frac) in enumerate(STAGE_CASES):
        x, th, maps, tabs = _model(20 + i, F, T, counts, pen_frac=frac)
        thd = torch.from_numpy(th).cuda()
        layers, cand = [], F * T
        for mp, tb in zip(maps, tabs):
            stack = R.LayerStack.build([torch.from_numpy(mp).cuda()],
                                       [torch.from_numpy(tb).cuda()], cand,
                                       "cuda")
            layers.append(next(stack.layers()))
            cand = mp.shape[0]
        masks = tbp.to_word_pattern(tbp.group_masks(cand, 5, "cuda"))
        for B in (1000, 33, 1, 0):
            xd = torch.from_numpy(x[:B]).cuda()
            before = _stage_counts()
            words = KT.thermometer_encode_packed(xd, thd)
            torch.cuda.synchronize()
            assert words.dtype == torch.int32
            assert torch.equal(tbp.from_word_pattern(words),
                               RT.thermometer_packed_plain(xd, thd)), (i, B)
            for (widx, boff, tab), m in zip(layers, counts):
                out = KL.lut_eval_packed(words, widx, boff, tab)
                torch.cuda.synchronize()
                assert torch.equal(
                    tbp.from_word_pattern(out),
                    RL.lut_eval_packed_plain(words, widx, boff, tab)), (i, B)
                # LUTs past m are the zero-table pad: their bits stay 0
                pad = tbp.unpack_bits(out, out.shape[1] * 32)[:, m:]
                assert not pad.any(), (i, B)
                words = out
            got_c, got_i = KP.popcount_classify_packed(words, masks)
            torch.cuda.synchronize()
            ref_c, ref_i = RP.popcount_classify_packed_plain(words, masks)
            assert torch.equal(got_c, ref_c) and torch.equal(got_i, ref_i)
            after = _stage_counts()
            assert after == {
                "thermometer_encode_packed":
                    before["thermometer_encode_packed"] + (B > 0),
                "lut_eval_packed":
                    before["lut_eval_packed"] + (B > 0) * len(layers),
                "popcount_classify_packed":
                    before["popcount_classify_packed"] + (B > 0)}, (i, B)


def test_staged_ops_on_card_match_fused_kernel():
    """Exact: the staged ops on the card give the fused packed kernel's
    counts and argmax; one pass launches K3 once, K4 once per layer and
    K5 once, and hands int32 bit patterns from stage to stage."""
    _need_card()
    for i, (F, T, counts, frac) in enumerate(STAGE_CASES):
        x, th, maps, tabs = _model(40 + i, F, T, counts, pen_frac=frac)
        thd = torch.from_numpy(th).cuda()
        maps_d = [torch.from_numpy(a).cuda() for a in maps]
        tabs_d = [torch.from_numpy(a).cuda() for a in tabs]
        fused = tops.make_forward_packed(thd, maps_d, tabs_d, 5)
        xd = torch.from_numpy(x).cuda()
        for K_ in (KT, KL, KP):
            K_.reset_launch_counts()
        packed = OT.encode_packed(xd, thd)
        assert packed.words.dtype == torch.int32
        for mp, tb in zip(maps_d, tabs_d):
            packed = OL.evaluate_packed(packed, mp, tb)
            assert packed.words.dtype == torch.int32
        got_c, got_i = OP.classify_packed(packed, 5)
        torch.cuda.synchronize()
        assert _stage_counts() == {"thermometer_encode_packed": 1,
                                   "lut_eval_packed": len(counts),
                                   "popcount_classify_packed": 1}
        ref_c, ref_i = fused(xd)
        assert torch.equal(got_c, ref_c) and torch.equal(got_i, ref_i), i


def test_cuda_stage_wrappers_refuse_bad_operands():
    """On the card the stage wrappers raise on operands they cannot take;
    they never fall back to the plain version."""
    _need_card()
    x, th, maps, tabs = _model(60, 16, 200, (64,), B=8)
    xd, thd = torch.from_numpy(x).cuda(), torch.from_numpy(th).cuda()
    with pytest.raises(ValueError, match="is on"):
        KT.thermometer_encode_packed(xd, thd.cpu())
    with pytest.raises(ValueError, match="float32"):
        KT.thermometer_encode_packed(xd.double(), thd)
    words = KT.thermometer_encode_packed(xd, thd)
    stack = R.LayerStack.build([torch.from_numpy(maps[0]).cuda()],
                               [torch.from_numpy(tabs[0]).cuda()], 3200,
                               "cuda")
    widx, boff, tab = next(stack.layers())
    with pytest.raises(ValueError, match="int32"):
        KL.lut_eval_packed(tbp.from_word_pattern(words), widx, boff, tab)
    with pytest.raises(ValueError, match="disagree"):
        KL.lut_eval_packed(words, widx[:40], boff[:40], tab[:40])
    out = KL.lut_eval_packed(words, widx, boff, tab)
    masks = tbp.to_word_pattern(tbp.group_masks(64, 4, "cuda"))
    with pytest.raises(ValueError, match="class_masks"):
        KP.popcount_classify_packed(out, masks[:, :1].contiguous())


# (F, T, lut_counts, PEN fraction bits) for the float kernels: lg width, a
# 2-layer stack, PEN ties, a ragged F*T = 21, and m = 2402 with 5 classes
# (two LUTs count for no class; K6 only, as K9 needs whole groups)
FLOAT_CASES = STAGE_CASES[:4] + [(16, 200, (2402,), None)]
FLOAT_KERNELS = ("thermometer_encode", "lut_eval", "popcount_classify",
                 "fused_dwn")


def _float_counts():
    return _stage_counts(FLOAT_KERNELS[:3]) | {
        "fused_dwn": K.launch_counts()["fused_dwn"]}


def test_cuda_float_kernels_match_plain():
    """Exact on {0,1} operands: K7, K8 (every layer), K9 and K6 each equal
    their plain version for ragged B (incl. 1 and 0) and several
    (block_b, block_m); one launch counted per non-empty call.  Soft bits
    (K8) within 1e-5, float tables (K6) within 1e-4."""
    _need_card()
    for i, (F, T, counts, frac) in enumerate(FLOAT_CASES):
        x, th, maps, tabs = _model(80 + i, F, T, counts, pen_frac=frac)
        thd = torch.from_numpy(th).cuda()
        maps_d = [torch.from_numpy(a).cuda() for a in maps]
        tabs_d = [torch.from_numpy(a).cuda().float() for a in tabs]
        for B in (1000, 33, 1, 0):
            xd = torch.from_numpy(x[:B]).cuda()
            before = _float_counts()
            bits = KT.thermometer_encode(xd, thd)
            torch.cuda.synchronize()
            assert torch.equal(bits, RT.thermometer_plain(xd, thd)), (i, B)
            bits = bits.reshape(B, F * T)
            for mp, tb in zip(maps_d, tabs_d):
                out = KL.lut_eval(bits, mp, tb.T.contiguous())
                torch.cuda.synchronize()
                assert torch.equal(out, RL.lut_eval_plain(bits, mp, tb)), \
                    (i, B)
                bits = out
            classified = bits.shape[1] % 5 == 0
            if classified:
                got = KP.popcount_classify(bits, 5)
                torch.cuda.synchronize()
                ref = RP.popcount_classify_plain(bits, 5)
                assert all(torch.equal(a, b) for a, b in zip(got, ref))
            fused = len(counts) == 1
            if fused:
                ref = R.fused_dwn_plain(xd, thd, maps_d[0], tabs_d[0], 5)
                for bb, bm in ((32, 128), (1, 7), (8, 256)):
                    got = K.fused_dwn(xd, thd, maps_d[0], tabs_d[0], 5,
                                      block_b=bb, block_m=bm)
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                        (i, B, bb, bm)
            assert _float_counts() == {
                "thermometer_encode":
                    before["thermometer_encode"] + (B > 0),
                "lut_eval": before["lut_eval"] + (B > 0) * len(counts),
                "popcount_classify":
                    before["popcount_classify"] + (B > 0) * classified,
                "fused_dwn": before["fused_dwn"] + (B > 0) * fused * 3}
    # IEEE compares: a denormal feature is above a 0.0 threshold
    dn = torch.tensor([[1e-40, -1e-40, 0.0]], device="cuda")
    got = KT.thermometer_encode(dn, torch.zeros((3, 2), device="cuda"))
    assert got.reshape(-1).tolist() == [1, 1, 0, 0, 0, 0]
    rng = np.random.default_rng(99)
    x, th, maps, tabs = _model(99, 16, 200, (2400,))
    xd, thd = torch.from_numpy(x).cuda(), torch.from_numpy(th).cuda()
    mp = torch.from_numpy(maps[0]).cuda()
    ftab = torch.from_numpy(rng.uniform(-1, 1, (2400, 64)).astype(
        np.float32)).cuda()
    soft = torch.from_numpy(rng.uniform(0, 1, (300, 3200)).astype(
        np.float32)).cuda()
    got = KL.lut_eval(soft, mp, ftab.T.contiguous())
    torch.testing.assert_close(got, RL.lut_eval_plain(soft, mp, ftab),
                               rtol=0, atol=1e-5)
    got_c, got_i = K.fused_dwn(xd, thd, mp, ftab, 5)
    ref_c, ref_i = R.fused_dwn_plain(xd, thd, mp, ftab, 5)
    torch.testing.assert_close(got_c, ref_c, rtol=0, atol=1e-4)
    top2 = ref_c.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert int(clear.sum()) > 900
    assert torch.equal(got_i[clear], ref_i[clear])


def test_float_ops_on_card_match_fused_kernels():
    """Exact: ``encode`` -> ``evaluate`` per layer -> ``classify`` on the
    card gives the counts and argmax of the float fused ``forward`` (one
    layer) and of the packed fused kernel; a pass launches K7 once, K8
    once per layer and K9 once, and ``forward`` launches K6 once."""
    _need_card()
    for i, (F, T, counts, frac) in enumerate(STAGE_CASES):
        x, th, maps, tabs = _model(120 + i, F, T, counts, pen_frac=frac)
        thd = torch.from_numpy(th).cuda()
        maps_d = [torch.from_numpy(a).cuda() for a in maps]
        tabs_d = [torch.from_numpy(a).cuda() for a in tabs]
        xd = torch.from_numpy(x).cuda()
        for K_ in (KT, KL, KP, K):
            K_.reset_launch_counts()
        bits = OT.encode(xd, thd)
        for mp, tb in zip(maps_d, tabs_d):
            bits = OL.evaluate(bits, mp, tb)
        got_c, got_i = OP.classify(bits, 5)
        torch.cuda.synchronize()
        assert _float_counts() == {"thermometer_encode": 1,
                                   "lut_eval": len(counts),
                                   "popcount_classify": 1, "fused_dwn": 0}
        ref_c, ref_i = tops.make_forward_packed(thd, maps_d, tabs_d, 5)(xd)
        assert torch.equal(got_c, ref_c) and torch.equal(got_i, ref_i), i
        if len(counts) == 1:
            f_c, f_i = tops.forward(xd, thd, maps_d[0], tabs_d[0], 5)
            torch.cuda.synchronize()
            assert K.launch_counts()["fused_dwn"] == 1
            assert torch.equal(f_c, ref_c) and torch.equal(f_i, ref_i), i


def test_cuda_float_wrappers_refuse_bad_operands():
    """On the card the float wrappers and ops raise on operands they
    cannot take (block_m < 1, fan-in above 8, classes that do not divide
    m, wires out of range, wrong dtype or device); they never fall back
    to the plain version."""
    _need_card()
    x, th, maps, tabs = _model(140, 16, 200, (64,), B=8)
    xd, thd = torch.from_numpy(x).cuda(), torch.from_numpy(th).cuda()
    mp = torch.from_numpy(maps[0]).cuda()
    tab = torch.from_numpy(tabs[0]).cuda().float()
    with pytest.raises(ValueError, match="is on"):
        KT.thermometer_encode(xd, thd.cpu())
    with pytest.raises(ValueError, match="float32"):
        KT.thermometer_encode(xd.double(), thd)
    bits = KT.thermometer_encode(xd, thd).reshape(8, -1)
    with pytest.raises(ValueError, match="fan-in"):
        KL.lut_eval(bits, torch.zeros((4, 9), dtype=torch.int32,
                                      device="cuda"),
                    torch.zeros((512, 4), device="cuda"))
    with pytest.raises(ValueError, match="corner-major"):
        KL.lut_eval(bits, mp, tab[:, :32].contiguous())
    with pytest.raises(ValueError, match="int32"):
        KL.lut_eval(bits, mp.long(), tab.T.contiguous())
    bad = mp.clone()
    bad[3, 2] = 3200
    with pytest.raises(ValueError, match="mapping indices"):
        OL.evaluate(bits, bad, tab)
    with pytest.raises(ValueError, match="mapping indices"):
        tops.forward(xd, thd, bad, tab, 5)
    out = KL.lut_eval(bits, mp, tab.T.contiguous())
    with pytest.raises(ValueError, match="equal class groups"):
        KP.popcount_classify(out, 5)
    with pytest.raises(ValueError, match="block_b and block_m"):
        K.fused_dwn(xd, thd, mp, tab, 5, block_m=0)
    with pytest.raises(ValueError, match="block_m"):
        FusedConfig(block_m=0)
    with pytest.raises(ValueError, match="fan-in"):
        K.fused_dwn(xd, thd, torch.zeros((4, 9), dtype=torch.int32,
                                         device="cuda"),
                    torch.zeros((4, 512), device="cuda"), 2)
    wide = torch.zeros((900, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        K.fused_dwn(xd, thd, wide, torch.zeros((900, 256), device="cuda"),
                    5, block_m=900)


FLASH_TOL = 2e-2
#: max |diff| over a query row's head dims over max |want| on that row:
#: deep in a flat softmax |o| is far below FLASH_TOL, so the elementwise
#: bar alone cannot see a wrong kernel there
FLASH_ROW_REL = 1e-2


def _attn_operands(seed, B, S, H, KH, hd, q_scale=0.5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((B, S, H, hd), generator=g, device="cuda") * q_scale,
            torch.randn((B, S, KH, hd), generator=g, device="cuda"),
            torch.randn((B, S, KH, hd), generator=g, device="cuda"))


#: sequence lengths around the hd-128 kernel's 128-row query blocks and
#: 96-key tiles
TILE_EDGES = (63, 95, 96, 97, 127, 128, 129, 193, 255, 257)


def test_flash_attention_matches_plain_on_card():
    """bf16 within 2e-2 of the plain version at the qwen3-8b head shape
    (32 query heads over 8 KV heads, hd 128) with S = 1, ragged S, S on
    either side of the query-block and key-tile edges and a few tiles,
    and with as many KV heads as query heads, causal and not, for a flat
    and a peaked softmax (q scaled by 0.5 and 4); hd 16; the reference's
    (BH, S, hd) layout.  Each query row within 1e-2 of its largest value
    against the plain version in float32.  One launch counted per
    call."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn.ref import attention_ref
    _need_card()
    cases = [(1, 1, 32, 8, 128), (2, 33, 32, 8, 128), (1, 200, 32, 8, 128),
             (2, 100, 4, 2, 16), (1, 77, 4, 4, 16), (2, 200, 8, 8, 128),
             (1, 1024, 32, 8, 128)]
    cases += [(1 + S % 2, S, 32, 8, 128) for S in TILE_EDGES]
    for i, (B, S, H, KH, hd) in enumerate(cases):
        for q_scale in (0.5, 4.0):
            q, k, v = (t.bfloat16() for t in
                       _attn_operands(i, B, S, H, KH, hd, q_scale))
            for causal in (True, False):
                before = FK.launch_counts()["flash_attention"]
                got = FK.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                assert FK.launch_counts()["flash_attention"] == before + 1
                want = attention_ref(q, k, v, causal=causal)
                assert got.dtype == torch.bfloat16 and got.shape == q.shape
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=FLASH_TOL, rtol=FLASH_TOL)
                exact = attention_ref(q.float(), k.float(), v.float(),
                                      causal=causal)
                row = ((got.float() - exact).abs().amax(-1)
                       / exact.abs().amax(-1).clamp_min(1e-30))
                assert float(row.max()) <= FLASH_ROW_REL, (
                    B, S, H, KH, hd, q_scale, causal, float(row.max()))
    q, k, v = (t.bfloat16() for t in _attn_operands(9, 6, 65, 1, 1, 128))
    fold = [t[:, :, 0].contiguous() for t in (q, k, v)]
    torch.testing.assert_close(
        FK.flash_attention(*fold, causal=True).float(),
        attention_ref(*fold, causal=True).float(), atol=FLASH_TOL,
        rtol=FLASH_TOL)


def test_flash_attention_graph_replay_equals_eager():
    """The launch captured in a CUDA graph (its tensor maps are kernel
    parameters, captured by value) replays to the eager call's output bit
    for bit, one launch counted per captured call."""
    from repro_torch.kernels.flash_attn import kernel as FK
    _need_card()
    q, k, v = (t.bfloat16() for t in _attn_operands(7, 2, 300, 32, 8, 128))
    eager = FK.flash_attention(q, k, v, causal=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FK.flash_attention(q, k, v, causal=True)      # warm-up off-graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = FK.launch_counts()["flash_attention"]
    with torch.cuda.graph(graph):
        out = FK.flash_attention(q, k, v, causal=True)
    assert FK.launch_counts()["flash_attention"] == before + 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_prefill_launches_flash_once_per_layer():
    """Reduced qwen3-8b on the card with ``attn_impl="pallas"``, at its
    head_dim 16 and at qwen3-8b's 128 (the served design): one
    flash-attention launch per layer in prefill, none in decode; the last
    logits within 0.05 relative of the ``masked`` path on the same
    params."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.models import transformer as TT
    _need_card()
    for head_dim in (16, 128):      # hd 128 runs the served design
        cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(),
                                  attn_impl="pallas", head_dim=head_dim)
        params = TT.init_params(cfg, seed=0, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda")
        FK.reset_launch_counts()
        lg, cache = TT.prefill(params, cfg, {"tokens": toks}, cache_len=44)
        torch.cuda.synchronize()
        assert FK.launch_counts()["flash_attention"] == cfg.num_layers
        TT.decode_step(params, cfg, cache, toks[:, :1])
        torch.cuda.synchronize()
        assert FK.launch_counts()["flash_attention"] == cfg.num_layers
        masked = dataclasses.replace(cfg, attn_impl="masked")
        ref, _ = TT.prefill(params, masked, {"tokens": toks}, cache_len=44)
        err = (lg.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert float(err) < 0.05, (head_dim, float(err))


def test_flash_wrapper_refuses_bad_operands():
    """On the card the wrapper raises on what the kernel does not take —
    a head_dim without an instance, float32, heads that do not group,
    non-contiguous or mixed-device operands, more batch x heads than the
    hd-16 grid holds — and never falls back to the plain version."""
    from repro_torch.kernels.flash_attn import kernel as FK
    _need_card()
    q, k, v = (t.bfloat16() for t in _attn_operands(0, 1, 16, 4, 2, 32))
    FK.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim 32"):
        FK.flash_attention(q, k, v)
    q, k, v = _attn_operands(0, 1, 16, 4, 2, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        FK.flash_attention(q, k, v)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    with pytest.raises(ValueError, match="grouped-query"):
        FK.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="is on"):
        FK.flash_attention(q, k.cpu(), v)
    # hd 16 puts batch x heads on the grid's y (at most 65535); hd 128 puts
    # them on x, so the same count launches there
    q, k, v = (t.bfloat16() for t in _attn_operands(0, 1, 1, 65536, 1, 16))
    with pytest.raises(ValueError, match="batch x heads"):
        FK.flash_attention(q, k, v)
    assert FK.launch_counts() == {"flash_attention": 0}
    q, k, v = (t.bfloat16() for t in _attn_operands(0, 1, 1, 65536, 1, 128))
    torch.testing.assert_close(FK.flash_attention(q, k, v).float(),
                               v.expand_as(q).float(), atol=0, rtol=0)
    assert FK.launch_counts() == {"flash_attention": 1}
