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
    tiles.  Activations too wide for a tile (once refused) lie in the
    global scratch and equal the plain version too."""
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
    ops = tops.prepare_operands(
        torch.from_numpy(th).cuda(), [torch.from_numpy(maps[0]).cuda()],
        [torch.from_numpy(tabs[0]).cuda()], 5)
    xd = torch.from_numpy(x).cuda()
    got = K.fused_dwn_packed(xd, *ops)
    assert K.last_launch()["scratch"] == 1
    ref = R.fused_dwn_packed_plain(xd, *ops)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


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


def test_async_serving_equals_sync_and_captures_nothing_in_session():
    """Exact: dwn-jsc-sm at max_bucket 256 on the card, ragged and
    oversize requests through ``serve()`` / ``submit_async`` equal the
    sync drain of the same payloads; every graph is captured before the
    loop starts (``compile_counts()`` unchanged by the session) and each
    step replays one K2 launch."""
    _need_card()
    from repro_torch.serving import ServingEngine, SLOConfig
    eng = ServingEngine("dwn-jsc-sm", max_bucket=256, n_train=2000)
    sizes = (5, 17, 256, 700, 3, 100, 1)
    payloads = [eng.make_request(n, seed=n) for n in sizes]
    for p in payloads:
        eng.submit(p)
    sync = sorted(eng.drain(), key=lambda r: r.rid)
    eng.start_serving(slo=SLOConfig(max_queue_samples=1 << 16))
    try:
        compiles = eng.compile_counts()
        assert sorted(compiles["fused-packed"]) == list(
            eng.scheduler.buckets)
        K.reset_launch_counts()
        reqs = [eng.submit_async(p) for p in payloads]
        results = [r.future.result(timeout=120) for r in reqs]
    finally:
        eng.stop_serving()
    launched = K.launch_counts()
    assert eng.compile_counts() == compiles
    steps = eng.report()["async"]["steps"]
    assert launched["fused_dwn_packed"] == steps > 0
    assert launched["fused_dwn_batch_major"] == 0
    for res, want in zip(results, sync):
        assert res.ok
        np.testing.assert_array_equal(res.value[0], want.result[0])
        np.testing.assert_array_equal(res.value[1], want.result[1])


LADDER = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


@pytest.fixture(scope="module")
def lg_engine():
    """dwn-jsc-lg on the card with the 8 ... 4096 bucket ladder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    from repro_torch.serving import ServingEngine
    return ServingEngine("dwn-jsc-lg", max_bucket=4096, min_bucket=8,
                         n_train=2000)


@pytest.mark.parametrize("variant", ["packed", "batch-major"])
def test_graph_replay_equals_eager_and_oracle_at_every_bucket(lg_engine,
                                                              variant):
    """Exact: at every bucket of the ladder (split tiles below 132 tiles,
    whole ones at 4096), the fused backend's replayed CUDA graph equals
    the eager call of the same kernel and the float oracle, on two sets
    of rows written into the captured input; the replay launches the
    variant's kernel (the first call at a bucket also warms up: two
    launches)."""
    eng = lg_engine
    model, bound = eng.model, eng.backends["fused-packed"]
    assert bound.graphed
    oracle = eng.backends["float-oracle"]
    x = eng.data.x_test                     # 4096 rows
    for b in LADDER:
        cfg = FusedConfig(variant, block_b=32)
        model.tuned_configs[b] = cfg
        eager = tops.make_forward_packed(model.thresholds, model.mappings,
                                         model.tables, 5, config=cfg)
        shuffled = x[np.random.default_rng(b).permutation(len(x))[:b]]
        for rows, launches in ((x[:b], 2), (shuffled, 1)):
            xh = torch.from_numpy(np.ascontiguousarray(rows))
            K.reset_launch_counts()
            got = [t.cpu().numpy() for t in bound.step_for(b)(xh)]
            assert K.launch_counts()[_fused_kernel(variant)[2]] == launches
            want = [t.cpu().numpy() for t in eager(xh.cuda())]
            ref = [t.cpu().numpy() for t in oracle(xh)]
            for g, w, r in zip(got, want, ref):
                np.testing.assert_array_equal(g, w, err_msg=str((b, cfg)))
                np.testing.assert_array_equal(g, r, err_msg=str((b, cfg)))
    model.tuned_configs.clear()


def test_changed_tuned_config_recaptures(lg_engine):
    """Setting ``tuned_configs[b]`` after a capture captures anew (the
    next step warms up and replays the new variant: two launches of it);
    going back replays the first graph without another capture."""
    eng = lg_engine
    bound, b = eng.backends["fused-packed"], 64
    xh = torch.from_numpy(np.ascontiguousarray(eng.data.x_test[:b]))
    eng.model.tuned_configs[b] = FusedConfig("packed", block_b=64)
    bound.step_for(b)(xh)
    n = bound.compiles[b]
    for variant, compiles, launches in (("batch-major", n + 1, 2),
                                        ("packed", n + 1, 1)):
        eng.model.tuned_configs[b] = FusedConfig(variant, block_b=64)
        K.reset_launch_counts()
        bound.step_for(b)(xh)
        assert bound.compiles[b] == compiles, variant
        assert K.launch_counts()[_fused_kernel(variant)[2]] == launches
    eng.model.tuned_configs.clear()


def test_launch_counts_under_replay(lg_engine):
    """The counters add a step's captured launches (the kernel, and the
    zero kernel before a split launch) on every replay, and nothing for
    the capture itself."""
    from repro_torch.kernels.graph import CapturedStep
    eng = lg_engine
    for b, zeroed in ((64, 1), (4096, 0)):
        fwd = tops.make_forward_packed(eng.model.thresholds,
                                       eng.model.mappings, eng.model.tables,
                                       5)
        step = CapturedStep(fwd, "cuda")
        xh = torch.from_numpy(np.ascontiguousarray(eng.data.x_test[:b]))
        K.reset_launch_counts()
        step(xh)
        assert step.launches == {"fused_dwn_packed": 1,
                                 **({"fused_dwn_zero": 1} if zeroed else {})}
        after_capture = K.launch_counts()
        for _ in range(4):
            step(xh)
        torch.cuda.synchronize()
        got = K.launch_counts()
        for name, n in step.launches.items():
            assert got[name] - after_capture[name] == 4 * n, (b, name)
        # the warmup call and the first replay; the capture counted
        # nothing
        assert after_capture["fused_dwn_packed"] == 2


def test_second_engine_on_the_same_cache_tunes_nothing(tmp_path,
                                                       monkeypatch):
    """An engine that tunes into a cache file leaves every bucket there;
    a second engine on the same file takes its configs from it and makes
    no timing call."""
    from repro_torch.kernels import autotune
    from repro_torch.serving import ServingEngine
    _need_card()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    first = ServingEngine("dwn-jsc-md", max_bucket=256, n_train=2000,
                          autotune=True)
    assert sorted(first.tuned_configs) == list(first.scheduler.buckets)
    calls = []
    timed = autotune.time_step
    monkeypatch.setattr(autotune, "time_step",
                        lambda *a, **k: calls.append(1) or timed(*a, **k))
    second = ServingEngine("dwn-jsc-md", max_bucket=256, n_train=2000,
                           autotune=True)
    assert calls == []
    assert second.tuned_configs == first.tuned_configs


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
    cannot take (block_m < 1, fan-in above 16, classes that do not divide
    m, wires out of range, wrong dtype or device); they never fall back
    to the plain version.  A block_m no block holds (once refused) takes
    K6's global path and equals the plain version."""
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
        KL.lut_eval(bits, torch.zeros((4, 17), dtype=torch.int32,
                                      device="cuda"),
                    torch.zeros((2 ** 17, 4), device="cuda"))
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
        K.fused_dwn(xd, thd, torch.zeros((4, 17), dtype=torch.int32,
                                         device="cuda"),
                    torch.zeros((4, 2 ** 17), device="cuda"), 2)
    wide = torch.zeros((900, 8), dtype=torch.int32, device="cuda")
    wide_tab = (torch.arange(900 * 256, device="cuda") % 3 == 0).float()
    wide_tab = wide_tab.reshape(900, 256)
    got = K.fused_dwn(xd, thd, wide, wide_tab, 5, block_m=900)
    assert K.last_float_launch()["path"] == "global"
    ref = R.fused_dwn_plain(xd, thd, wide, wide_tab, 5)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _replayed(fn):
    """``fn()``'s outputs from one replay of a CUDA graph that captured
    it, after a warm-up on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


TILE_BATCHES = (1, 31, 33, 1000, 4096, 4097)
#: (W_in words, LUTs, fan-in, path) of K4: lg width at fan-in 6, fan-in 1,
#: 10 and 16 (a word of fan-in-16 LUTs does not fit a block: the rows
#: kernel), the widest rows a tile takes and the widest the rows kernel
#: takes
K4_CASES = [(100, 2400, 6, "tiles"), (100, 480, 1, "tiles"),
            (100, 480, 10, "tiles"), (100, 480, 16, "rows"),
            (454, 256, 6, "tiles"), (7264, 256, 6, "rows")]


@pytest.mark.parametrize("W_in,m,n,path", K4_CASES)
def test_cuda_lut_eval_packed_tiles_match_plain(W_in, m, n, path):
    """Exact: K4 equals its plain version at every B of TILE_BATCHES on
    random words, through the planned path, with the pad bits past m
    zero; one launch a call; a CUDA graph replay equals the eager call."""
    _need_card()
    rng = np.random.default_rng(W_in + n)
    words = tbp.to_word_pattern(torch.from_numpy(rng.integers(
        0, 2 ** 32, (max(TILE_BATCHES), W_in), dtype=np.uint64).astype(
        np.int64))).cuda()
    mp = torch.from_numpy(rng.integers(0, W_in * 32, (m, n)).astype(
        np.int32)).cuda()
    tb = torch.from_numpy(rng.integers(0, 2, (m, 2 ** n)).astype(
        np.int32)).cuda()
    layer = next(R.LayerStack.build([mp], [tb], W_in * 32, "cuda").layers())
    for B in TILE_BATCHES:
        before = KL.launch_counts()["lut_eval_packed"]
        out = KL.lut_eval_packed(words[:B], *layer)
        torch.cuda.synchronize()
        assert KL.last_launch()["path"] == path, B
        assert KL.launch_counts()["lut_eval_packed"] == before + 1
        assert torch.equal(tbp.from_word_pattern(out),
                           RL.lut_eval_packed_plain(words[:B], *layer)), B
        assert not tbp.unpack_bits(out, out.shape[1] * 32)[:, m:].any(), B
    assert torch.equal(_replayed(lambda: KL.lut_eval_packed(words, *layer)),
                       out)


#: (F, T, LUTs, fan-in, path) of K6: lg-2400, lg-2402 (two LUTs count for
#: no class), every other fan-in from 1 to 8, and features too wide for a
#: tile of 32 samples (the rows kernel)
K6_CASES = [(16, 200, 2400, 6, "tiles"), (16, 200, 2402, 6, "tiles"),
            *((16, 200, 1000, n, "tiles") for n in (1, 2, 3, 4, 5, 7, 8)),
            (500, 4, 130, 6, "rows")]


@pytest.mark.parametrize("F,T,m,n,path", K6_CASES)
def test_cuda_fused_dwn_tiles_match_plain(F, T, m, n, path):
    """K6 equals its plain version exactly on {0,1} tables at every B of
    TILE_BATCHES through the planned path, one ``fused_dwn`` launch a call
    (and one ``fused_dwn_combine`` on the tiles path); on float tables
    within 1e-4, and bitwise the same in a second call and in a CUDA graph
    replay."""
    _need_card()
    x, th, maps, tabs = _model(150 + n + m, F, T, (m,), n=n,
                               B=max(TILE_BATCHES))
    xd, thd = torch.from_numpy(x).cuda(), torch.from_numpy(th).cuda()
    mp = torch.from_numpy(maps[0]).cuda()
    tab = torch.from_numpy(tabs[0]).cuda().float()
    for B in TILE_BATCHES:
        before = K.launch_counts()
        got = K.fused_dwn(xd[:B], thd, mp, tab, 5)
        torch.cuda.synchronize()
        assert K.last_float_launch()["path"] == path, B
        after = K.launch_counts()
        assert after["fused_dwn"] == before["fused_dwn"] + 1
        assert after["fused_dwn_combine"] == \
            before["fused_dwn_combine"] + (path == "tiles")
        ref = R.fused_dwn_plain(xd[:B], thd, mp, tab, 5)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    ftab = torch.from_numpy(np.random.default_rng(n).uniform(
        -1, 1, (m, 2 ** n)).astype(np.float32)).cuda()
    got = K.fused_dwn(xd, thd, mp, ftab, 5)
    ref = R.fused_dwn_plain(xd, thd, mp, ftab, 5)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    again = K.fused_dwn(xd, thd, mp, ftab, 5)
    graphed = _replayed(lambda: K.fused_dwn(xd, thd, mp, ftab, 5))
    for out in (again, graphed):
        assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])


def test_cuda_fused_dwn_rounds_block_b_and_block_m():
    """Any block_b, block_m >= 1 gives the plain version's counts on
    {0,1} tables: tiles of a multiple of 32 samples (cut to what fits),
    slices of whole 32-LUT chunks cut at class groups and to what fits a
    block (764 LUTs: over a tile block, the most the rows kernel took),
    or, where block_m's LUTs alone fit no block (once refused), the
    global path; ``forward`` carries a FusedConfig's block_b and block_m
    to the kernel."""
    _need_card()
    x, th, maps, tabs = _model(170, 16, 200, (2400,), B=1000)
    xd, thd = torch.from_numpy(x).cuda(), torch.from_numpy(th).cuda()
    mp = torch.from_numpy(maps[0]).cuda()
    tab = torch.from_numpy(tabs[0]).cuda().float()
    ref = R.fused_dwn_plain(xd, thd, mp, tab, 5)
    for bb, bm in ((1, 1), (7, 7), (33, 100), (64, 128), (4096, 480),
                   (32, 764)):
        got = K.fused_dwn(xd, thd, mp, tab, 5, block_b=bb, block_m=bm)
        torch.cuda.synchronize()
        lay = K.last_float_launch()
        plan = K.plan_fused_dwn(1000, 16, 2400, 6, 5, bb, bm,
                                torch.cuda.get_device_properties(
                                    0).multi_processor_count)
        assert lay["path"] == "tiles" and lay["tile_rows"] % 32 == 0
        assert (lay["tile_rows"], lay["slices"], lay["cs"]) == \
            (plan.tile_rows, plan.slices, plan.cs)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = K.fused_dwn(xd, thd, mp, tab, 5, block_m=2400)
    assert K.last_float_launch()["path"] == "global"
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = tops.forward(xd, thd, mp, tab, 5,
                       config=FusedConfig(block_b=64, block_m=256))
    assert K.last_float_launch()["tile_rows"] == 64
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_cuda_fused_dwn_combine_matches_plain():
    """Exact: the combine kernel alone adds each class's chunk sums in
    the plain version's order (random float sums), first argmax."""
    _need_card()
    rng = np.random.default_rng(180)
    for rows, C, B in ((75, 5, 4097), (30, 10, 1), (5, 5, 33)):
        part = torch.from_numpy(rng.uniform(-16, 16, (rows, B)).astype(
            np.float32)).cuda()
        got = K.fused_dwn_combine(part, C)
        torch.cuda.synchronize()
        ref = R.fused_dwn_combine_plain(part, C)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


#: (C bits, LUTs, fan-in, path) of K8: lg width at every fan-in from 1 to
#: 8, the widest rows a tile takes, the narrowest the rows kernel takes
#: and the widest it takes (one row a block)
K8_CASES = [(3200, 2400, 6, "tiles"),
            *((3200, 300, n, "tiles") for n in (1, 2, 3, 4, 5, 7, 8)),
            (3632, 300, 6, "tiles"), (3633, 300, 6, "rows"),
            (58_112, 64, 6, "rows")]


@pytest.mark.parametrize("C,m,n,path", K8_CASES)
def test_cuda_lut_eval_tiles_match_plain(C, m, n, path):
    """K8 equals its plain version exactly on {0,1} bits and tables at
    every B of TILE_BATCHES (fewer rows on the widest case) through the
    planned path, one launch a call; on soft bits within 1e-5, with {0,1}
    and with float tables; a CUDA graph replay equals the eager call."""
    _need_card()
    rng = np.random.default_rng(C + 10 * n)
    batches = TILE_BATCHES if C <= 3633 else (1, 31, 33, 100)
    Bmax = max(batches)
    bits = torch.from_numpy((rng.random((Bmax, C)) < 0.5).astype(
        np.float32)).cuda()
    mp = torch.from_numpy(rng.integers(0, C, (m, n)).astype(np.int32)).cuda()
    tab = torch.from_numpy(rng.integers(0, 2, (m, 2 ** n)).astype(
        np.float32)).cuda()
    tab_t = tab.T.contiguous()
    for B in batches:
        before = KL.launch_counts()["lut_eval"]
        out = KL.lut_eval(bits[:B], mp, tab_t)
        torch.cuda.synchronize()
        assert KL.last_float_launch()["path"] == path, B
        assert KL.launch_counts()["lut_eval"] == before + 1
        assert torch.equal(out, RL.lut_eval_plain(bits[:B], mp, tab)), B
    soft = torch.from_numpy(rng.uniform(0, 1, (min(Bmax, 300), C)).astype(
        np.float32)).cuda()
    ftab = torch.from_numpy(rng.uniform(-1, 1, (m, 2 ** n)).astype(
        np.float32)).cuda()
    for tb in (tab, ftab):
        got = KL.lut_eval(soft, mp, tb.T.contiguous())
        torch.testing.assert_close(got, RL.lut_eval_plain(soft, mp, tb),
                                   rtol=0, atol=1e-5)
    assert torch.equal(_replayed(lambda: KL.lut_eval(bits, mp, tab_t)), out)


#: (F, T, PEN fraction bits, path) of K3: lg width, PEN ties, ragged
#: words (F*T = 21 and 65), thresholds too large for one block (F*T =
#: 64,000 bits: several slices at any B) and features too many for a tile
#: (the rows kernel)
K3_CASES = [(16, 200, None, "tiles"), (16, 200, 8, "tiles"),
            (3, 7, None, "tiles"), (5, 13, None, "tiles"),
            (16, 4000, None, "tiles"), (500, 4, None, "rows")]


@pytest.mark.parametrize("F,T,frac,path", K3_CASES)
def test_cuda_thermometer_encode_packed_tiles_match_plain(F, T, frac, path):
    """K3 equals its plain version exactly at every B of TILE_BATCHES
    through the planned path, one launch a call, pad bits zero; NaN
    features compare false and denormal ones above a 0.0 threshold; a CUDA
    graph replay equals the eager call."""
    _need_card()
    x, th, _, _ = _model(190 + F + T, F, T, (), B=max(TILE_BATCHES),
                         pen_frac=frac)
    x[5, : min(F, 3)] = np.nan
    x[7, 0] = 1e-40
    x[9, 0] = -1e-40
    th[0, 0] = 0.0
    xd, thd = torch.from_numpy(x).cuda(), torch.from_numpy(th).cuda()
    for B in TILE_BATCHES:
        before = KT.launch_counts()["thermometer_encode_packed"]
        words = KT.thermometer_encode_packed(xd[:B], thd)
        torch.cuda.synchronize()
        assert KT.last_launch()["path"] == path, B
        assert KT.launch_counts()["thermometer_encode_packed"] == before + 1
        assert torch.equal(tbp.from_word_pattern(words),
                           RT.thermometer_packed_plain(xd[:B], thd)), B
    bits = tbp.unpack_bits(words, words.shape[1] * 32)
    assert not bits[:, F * T:].any()
    assert not bits[5, :min(F, 3) * T].any()           # NaN: all false
    assert bool(bits[7, 0]) and not bool(bits[9, 0])   # denormals
    assert torch.equal(_replayed(lambda: KT.thermometer_encode_packed(
        xd, thd)), words)


#: (W words, C classes, masks, path) of K5: lg width (W = 75, C = 5) on
#: contiguous class groups, random masks with all-zero and all-one words
#: and strided masks (bit i to class i % C); MNIST-lg (2000 LUTs, 10
#: classes: W = 63); the narrowest rows; the most classes a tile takes
#: (32); the widest rows a tile takes at 5 classes; one word wider and 33
#: classes (the rows kernel)
K5_CASES = [(75, 5, "groups", "tiles"), (75, 5, "random", "tiles"),
            (75, 5, "strided", "tiles"), (63, 10, "groups", "tiles"),
            (2, 5, "random", "tiles"), (7, 10, "strided", "tiles"),
            (75, 32, "random", "tiles"), (1565, 5, "random", "tiles"),
            (1566, 5, "random", "rows"), (75, 33, "random", "rows")]


def _k5_masks(kind, rng, W, C):
    """(C, W) class masks as int32 bit patterns on the card."""
    if kind == "groups":
        masks = tbp.group_masks_np(32 * W - 32 * W % C, C)
    elif kind == "strided":
        bits = np.arange(W * 32)[None] % C == np.arange(C)[:, None]
        masks = tbp.pack_bits_np(bits)
    else:
        masks = rng.integers(0, 2 ** 32, (C, W), dtype=np.uint64)
        masks[:, ::5] = 0
        masks[:, 1::7] = 2 ** 32 - 1
    return tbp.to_word_pattern(torch.from_numpy(
        np.asarray(masks).astype(np.int64))).cuda()


@pytest.mark.parametrize("W,C,kind,path", K5_CASES)
def test_cuda_popcount_classify_packed_tiles_match_plain(W, C, kind, path):
    """K5 equals its plain version exactly at every B of TILE_BATCHES
    through the planned path, one launch a call; all-zero rows tie every
    class and give class 0; a CUDA graph replay equals the eager call."""
    _need_card()
    rng = np.random.default_rng(200 + W + C)
    words = rng.integers(0, 2 ** 32, (max(TILE_BATCHES), W), dtype=np.uint64)
    words[:3] = 0
    words = tbp.to_word_pattern(torch.from_numpy(words.astype(
        np.int64))).cuda()
    masks = _k5_masks(kind, rng, W, C)
    for B in TILE_BATCHES:
        before = KP.launch_counts()["popcount_classify_packed"]
        counts, idx = KP.popcount_classify_packed(words[:B], masks)
        torch.cuda.synchronize()
        assert KP.last_launch()["path"] == path, B
        assert KP.launch_counts()["popcount_classify_packed"] == before + 1
        ref_c, ref_i = RP.popcount_classify_packed_plain(words[:B], masks)
        assert torch.equal(counts, ref_c) and torch.equal(idx, ref_i), B
        assert not idx[:3].any() and not counts[:3].any()
    graphed = _replayed(lambda: KP.popcount_classify_packed(words, masks))
    assert torch.equal(graphed[0], counts) and torch.equal(graphed[1], idx)


def test_classify_packed_replays_in_a_cuda_graph():
    """``classify_packed`` makes its class masks once per (bits, classes,
    device): a CUDA graph captures it (a host-to-device copy would be
    refused) and its replay equals the eager call and the plain
    version."""
    _need_card()
    bits = torch.from_numpy((np.random.default_rng(210).random(
        (4096, 2400)) < 0.5).astype(np.float32))
    packed = tbp.PackedBits(tbp.to_word_pattern(tbp.pack_bits(bits)).cuda(),
                            2400)
    OP.class_masks.cache_clear()
    eager = OP.classify_packed(packed, 5)
    graphed = _replayed(lambda: OP.classify_packed(packed, 5))
    assert OP.class_masks.cache_info().misses == 1
    ref = RP.popcount_classify_packed_plain(
        packed.words, OP.class_masks(2400, 5, packed.words.device))
    for out in (graphed, ref):
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


FLASH_TOL = 2e-2
FLASH_TOL = 2e-2
#: max |diff| over a query row's head dims over max |want| on that row:
#: deep in a flat softmax |o| is far below FLASH_TOL, so the elementwise
#: bar alone cannot see a wrong kernel there
FLASH_ROW_REL = 1e-2
#: the same bar for rows of 8 to 31 head dims, whose largest value is no
#: steady scale (chip_smoke.FLASH_ROW_REL_NARROW); fewer than 8 are held
#: elementwise alone
FLASH_ROW_REL_NARROW = 2e-2


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
    and a peaked softmax (q scaled by 0.5 and 4); hd 16; GQA launches
    whose K and V pass the 40 MB past which MHA blocks run in groups
    (``head_group``), where GQA keeps the order by query block: qwen3-8b's
    heads at 8 x 2048, the lm_head phase's classify requests (67 MB), and
    granite-moe's at 10 x 2048 (42 MB); the reference's (BH, S, hd)
    layout.  Each query row within 1e-2 of its largest value
    against the plain version in float32.  One launch counted per
    call."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn.ref import attention_ref
    _need_card()
    cases = [(1, 1, 32, 8, 128), (2, 33, 32, 8, 128), (1, 200, 32, 8, 128),
             (2, 100, 4, 2, 16), (1, 77, 4, 4, 16), (2, 200, 8, 8, 128),
             (1, 1024, 32, 8, 128)]
    cases += [(1 + S % 2, S, 32, 8, 128) for S in TILE_EDGES]
    cases += [(8, 2048, 32, 8, 128), (10, 2048, 24, 8, 64)]
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


#: sequence lengths around the Hopper design's 128-row query blocks, its
#: 96-key (hd 96 and 128) and 128-key (hd 64) tiles, and a few tiles
WS_EDGES = (1, 63, 95, 96, 97, 127, 128, 129, 191, 192, 193, 255, 256, 257,
            1024)


def _row_rel(got, q, k, v, causal):
    """The largest over query rows of max |got - exact| over the row's
    largest |exact|, the exact output in float32."""
    from repro_torch.kernels.flash_attn.ref import attention_ref
    exact = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    row = ((got.float() - exact).abs().amax(-1)
           / exact.abs().amax(-1).clamp_min(1e-30))
    return float(row.max())


@pytest.mark.parametrize("H,KH,hd", [(24, 8, 64), (32, 32, 96),
                                     (28, 4, 128), (40, 8, 128),
                                     (56, 8, 128)])
def test_flash_attention_lm_zoo_head_shapes_match_plain_on_card(H, KH, hd):
    """The head shapes of the LM zoo on the Hopper design: hd 64
    (granite-moe, 24 query heads over 8 KV heads), hd 96 (phi3-mini, MHA)
    and hd 128 at qwen2-7b's (28 over 4), qwen3-14b's (40 over 8) and
    llava-next-34b's (56 over 8) head shapes, at sequence lengths on either side of its query blocks and key
    tiles (WS_EDGES) and at B = 3, S = 2000, where phi3-mini's K and V run
    in groups of 13 (b, h) pairs, the last of 5; causal and not, flat and
    peaked softmax: within 2e-2 of the plain version in bf16 and each
    query row within 1e-2 of its largest value in float32, one launch
    counted a call."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn.ref import attention_ref
    _need_card()
    sizes = [(1 + S % 2, S) for S in WS_EDGES] + [(3, 2000)]
    for i, (B, S) in enumerate(sizes):
        for q_scale in (0.5, 4.0):
            q, k, v = (t.bfloat16() for t in
                       _attn_operands(100 + i, B, S, H, KH, hd, q_scale))
            for causal in (True, False):
                before = FK.launch_counts()["flash_attention"]
                got = FK.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                assert FK.launch_counts()["flash_attention"] == before + 1
                torch.testing.assert_close(
                    got.float(), attention_ref(q, k, v, causal=causal).float(),
                    atol=FLASH_TOL, rtol=FLASH_TOL)
                row = _row_rel(got, q, k, v, causal)
                assert row <= FLASH_ROW_REL, (B, S, q_scale, causal, row)


@pytest.mark.parametrize("H,KH,hd", [(24, 8, 64), (32, 32, 96)])
def test_flash_attention_first_design_matches_plain_on_card(H, KH, hd):
    """The first design (mma.sync) at hd 64 and 96, kept behind
    ``flash_attn_mma_launch`` for chip_smoke.py's same-call comparison:
    within 2e-2 of the plain version and each query row within 1e-2,
    causal and not, flat and peaked softmax, at sequence lengths around
    its 64-row blocks; the wrapper's launch count does not move."""
    from repro_torch.kernels._launch import bind
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn.ref import attention_ref
    _need_card()
    lib = bind(FK.LIBRARY, FK._SIGNATURES)
    before = FK.launch_counts()
    for i, S in enumerate((1, 63, 64, 65, 127, 129, 200, 1024)):
        B = 1 + S % 2
        for q_scale in (0.5, 4.0):
            q, k, v = (t.bfloat16() for t in
                       _attn_operands(200 + i, B, S, H, KH, hd, q_scale))
            for causal in (True, False):
                got = torch.empty_like(q)
                err = lib.flash_attn_mma_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(),
                    B, S, H, KH, hd, int(causal),
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got.float(), attention_ref(q, k, v, causal=causal).float(),
                    atol=FLASH_TOL, rtol=FLASH_TOL)
                row = _row_rel(got, q, k, v, causal)
                assert row <= FLASH_ROW_REL, (B, S, q_scale, causal, row)
    assert FK.launch_counts() == before


def test_flash_attention_at_llavas_served_shape_matches_plain_on_card():
    """llava-next-34b's served prefill: B = 2, S = 2880 patch positions +
    1024 tokens = 3904 (its last 128-row query block holds 64 rows, its
    last 96-key tile 64 keys), 56 query heads over 8 KV heads, hd 128;
    causal and not, flat and peaked softmax: within 2e-2 of the plain
    version and each query row within 1e-2 of its largest value."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn.ref import attention_ref
    _need_card()
    for q_scale in (0.5, 4.0):
        q, k, v = (t.bfloat16() for t in
                   _attn_operands(300, 2, 3904, 56, 8, 128, q_scale))
        for causal in (True, False):
            got = FK.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got.float(), attention_ref(q, k, v, causal=causal).float(),
                atol=FLASH_TOL, rtol=FLASH_TOL)
            row = _row_rel(got, q, k, v, causal)
            assert row <= FLASH_ROW_REL, (q_scale, causal, row)
            del got
            torch.cuda.empty_cache()


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
    head_dim 16 (the mma.sync design), at granite-moe's 64, phi3-mini's
    96 and at qwen3-8b's 128 (the Hopper design): one
    flash-attention launch per layer in prefill, none in decode; the last
    logits within 0.05 relative of the ``masked`` path on the same
    params."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.models import transformer as TT
    _need_card()
    for head_dim in (16, 64, 96, 128):
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


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b", "phi3-mini-3.8b",
                                  "granite-moe-3b-a800m", "mixtral-8x7b"])
def test_lm_zoo_reduced_on_the_card_matches_the_cpu(arch):
    """Each dense and MoE arch, reduced, with ``attn_impl="pallas"``: the
    card's prefill (one flash launch a layer; none under mixtral's window)
    and a decode step past the window's ring, within 0.05 relative of the
    same params on the CPU (its plain versions)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adam import map_tree
    _need_card()
    cfg = dataclasses.replace(get_arch(arch).reduced(), attn_impl="pallas")
    cpu = TT.init_params(cfg, seed=0)
    card = map_tree(lambda t: t.cuda(), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        FK.reset_launch_counts()
        lg, cache = TT.prefill(params, cfg, {"tokens": toks[:, :36].to(dev)},
                               cache_len=40)
        step, _ = TT.decode_step(params, cfg, cache, toks[:, 36:].to(dev))
        torch.cuda.synchronize()
        out[dev] = (lg.float().cpu(), step.float().cpu(),
                    FK.launch_counts()["flash_attention"])
    flash = cfg.num_layers if cfg.swa_window is None else 0
    assert out["cpu"][2] == 0 and out["cuda"][2] == flash
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) < 0.05, (arch, float(err))


@pytest.mark.parametrize("arch", ["llava-next-34b", "mamba2-1.3b",
                                  "recurrentgemma-2b", "whisper-large-v3"])
def test_lm_families_reduced_on_the_card_match_the_cpu(arch):
    """The VLM (under ``attn_impl="pallas"``), SSM, hybrid and
    encoder-decoder archs, reduced, with their stub frontend's inputs:
    the card's prefill of 36 tokens (one flash launch a layer for llava,
    none for the others) and two decode steps (the hybrid's 8-slot ring
    wrapped unaligned), within 0.05 relative of the same params on the
    CPU."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.models import api
    from repro_torch.optim.adam import map_tree
    _need_card()
    cfg = dataclasses.replace(get_arch(arch).reduced(), attn_impl="pallas")
    mod = api.module_for(cfg)
    cpu = mod.init_params(cfg, seed=0)
    card = map_tree(lambda t: t.cuda(), cpu)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 38), generator=g)
    stub = {}
    if cfg.family == "vlm":
        stub["patches"] = torch.randn((2, cfg.num_patches, cfg.d_model),
                                      generator=g) * 0.02
    if cfg.family == "encdec":
        stub["frames"] = torch.randn((2, cfg.enc_frames, cfg.d_model),
                                     generator=g) * 0.1
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        FK.reset_launch_counts()
        batch = {"tokens": toks[:, :36].to(dev),
                 **{k: v.to(dev, torch.bfloat16) for k, v in stub.items()}}
        lg, cache = mod.prefill(params, cfg, batch, cache_len=40)
        steps = [lg]
        for t in (36, 37):
            step, cache = mod.decode_step(params, cfg, cache,
                                          toks[:, t:t + 1].to(dev))
            steps.append(step)
        torch.cuda.synchronize()
        out[dev] = ([x.float().cpu() for x in steps],
                    FK.launch_counts()["flash_attention"])
    flash = cfg.num_layers if cfg.family == "vlm" else 0
    assert out["cpu"][1] == 0 and out["cuda"][1] == flash
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) < 0.05, (arch, float(err))


def test_flash_wrapper_refuses_bad_operands():
    """On the card the wrapper raises on what the kernel does not take —
    a head_dim above 256, float32, heads that do not group, non-contiguous
    or mixed-device operands — and never falls back to the plain version;
    batch x heads past the hd-16 grid's y (once refused) folds into its
    x."""
    from repro_torch.kernels.flash_attn import kernel as FK
    _need_card()
    q, k, v = (t.bfloat16() for t in _attn_operands(0, 1, 16, 4, 2, 257))
    FK.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim 257"):
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
    assert FK.launch_counts() == {"flash_attention": 0}
    # hd 16 puts batch x heads on the grid's y, the part past 65,535 on
    # its x; the Hopper design (hd 128) one block a (query block, b, h) on
    # x: one key a row, so the output is v
    for hd in (16, 128):
        q, k, v = (t.bfloat16()
                   for t in _attn_operands(0, 1, 1, 65536, 1, hd))
        torch.testing.assert_close(FK.flash_attention(q, k, v).float(),
                                   v.expand_as(q).float(), atol=0, rtol=0)
    assert FK.launch_counts() == {"flash_attention": 2}


# -- DWN training on the card ----------------------------------------------

def _train_setup(luts, device, n=2000, seed=0):
    """A numpy init of ``luts`` (seed 0) as params, Adam state, encoded
    split and labels on ``device``, and the step program of that shape."""
    from repro_torch.core.model import DWNConfig, params_from_numpy
    from repro_torch.core.thermometer import fit_thresholds
    from repro_torch.data.jsc import load_jsc
    from repro_torch.training import encode_dataset, step_program
    cfg = DWNConfig(lut_counts=luts)
    data = load_jsc(n, 200, seed=seed)
    rng = np.random.default_rng(seed)
    layers = [{"scores": rng.normal(0, 0.01, (s.num_luts, s.fan_in,
                                              s.num_candidates)),
               "tables": rng.uniform(-1, 1, (s.num_luts, s.table_size))}
              for s in cfg.layer_specs()]
    params, buffers = params_from_numpy(
        {"layers": layers},
        {"thresholds": fit_thresholds(data.x_train, cfg.thermometer)},
        device=device)
    bits = encode_dataset(data.x_train, buffers["thresholds"])
    y = torch.from_numpy(data.y_train.astype(np.int64)).to(device)
    prog = step_program(cfg, n, bits.shape[1], 128, 1e-3, "steplr", device)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)[
        :prog.steps * 128].astype(np.int64)).to(device)
    return prog, (params, bits, y), perm


def _steps(prog, state, perm, k, *, eager=False):
    from repro_torch.optim.adam import leaves, map_tree
    params, bits, y = state
    params = map_tree(torch.clone, params)
    opt_state = prog.opt.init(params)
    prog.load(params, opt_state, bits, y)
    prog.begin_epoch(perm)
    for _ in range(k):
        prog.step(eager=eager)
    prog.store(params, opt_state)
    return prog.losses[:k].clone(), leaves(params)


@pytest.mark.parametrize("luts", [(360,), (120, 50)])
def test_training_step_replays_equal_eager_steps(luts):
    """Bitwise: 4 replays of the captured step give the eager steps'
    losses and parameters, two card runs give the same, and a run with
    TF32 allowed by the caller gives the same (the step forces full
    float32 itself)."""
    _need_card()
    prog, state, perm = _train_setup(luts, "cuda")
    loss_r, par_r = _steps(prog, state, perm, 4)
    loss_e, par_e = _steps(prog, state, perm, 4, eager=True)
    loss_2, par_2 = _steps(prog, state, perm, 4)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss_t, par_t = _steps(prog, state, perm, 4, eager=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for loss, par in ((loss_e, par_e), (loss_2, par_2), (loss_t, par_t)):
        assert torch.equal(loss, loss_r)
        assert all(torch.equal(a, b) for a, b in zip(par, par_r))


@pytest.mark.parametrize("luts", [(360,), (120, 50)])
def test_training_steps_on_the_card_match_the_cpu(luts):
    """4 steps from one numpy init: per-step losses within 1e-5, scores
    within 1e-4, table signs and the frozen wiring identical (the card
    and the CPU sum in other orders)."""
    _need_card()
    prog_c, state_c, perm_c = _train_setup(luts, "cuda")
    prog_h, state_h, perm_h = _train_setup(luts, "cpu")
    loss_c, par_c = _steps(prog_c, state_c, perm_c, 4)
    loss_h, par_h = _steps(prog_h, state_h, perm_h, 4)
    assert float((loss_c.cpu() - loss_h).abs().max()) <= 1e-5
    for i in range(0, len(par_c), 2):
        sc, sh = par_c[i].cpu(), par_h[i]
        assert float((sc - sh).abs().max()) <= 1e-4
        assert torch.equal(sc.argmax(-1), sh.argmax(-1))
        assert torch.equal(par_c[i + 1].cpu() > 0, par_h[i + 1] > 0)


def test_scan_trainer_epoch_on_the_card():
    """One epoch of ``ScanTrainer`` on the card: finite losses, the step
    counter at steps_per_epoch, accuracy above chance; a second trainer
    of the shape reuses the captured program."""
    _need_card()
    from repro_torch.core.model import JSC_PRESETS
    from repro_torch.data.jsc import load_jsc
    from repro_torch.training import ScanTrainer
    data = load_jsc(2000, 500, seed=0)
    tr = ScanTrainer(JSC_PRESETS["sm-50"], data, seed=0)
    res = tr.train(1)
    assert int(tr.opt_state.step) == tr.steps_per_epoch
    assert np.isfinite(res.history[0]["loss"])
    assert res.soft_test_acc > 0.3
    tr2 = ScanTrainer(JSC_PRESETS["sm-50"], data, seed=1)
    assert tr2.program is tr.program and tr.program.graph is not None


@pytest.mark.parametrize("name", ["dwn-mnist-sm", "dwn-mnist-lg"])
@pytest.mark.parametrize("variant", ["packed", "batch-major"])
def test_mnist_served_through_kernels_equals_plain_and_apply_hard(name,
                                                                  variant):
    """Exact: at MNIST width (F = 196, 10 classes; sm: 100 LUTs over T = 8,
    lg: 2000 over T = 16) K2 and K1 equal their plain versions and
    ``apply_hard`` at B = 1, 33 and 4096, one launch each, the model
    staged; at B = 1 and 33 (far fewer tiles than SMs) the last layer's
    words split over blocks, the zero kernel first, and at 4096 (128
    tiles) they do not.  Then the engine, pinned
    to the variant at every bucket, serves requests of 1, 33 and 4096
    rows through CUDA graph replays that launch the variant, each equal
    to ``apply_hard``."""
    _need_card()
    from repro_torch.core.model import apply_hard
    from repro_torch.dwn import DWNArtifact, get_spec
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads import load_workload
    data = load_workload("mnist", 2000, 4096, seed=0)
    art = DWNArtifact(get_spec(name)).fit(data.x_train, seed=0).freeze()
    art.pack("cuda")
    p = art.packed
    kern, plain, count = _fused_kernel(variant)
    ops = tops.prepare_operands(p.thresholds, p.mappings, p.tables, 10,
                                variant)
    for B in (1, 33, 4096):
        x = torch.from_numpy(data.x_test[:B]).cuda()
        K.reset_launch_counts()
        got = kern(x, *ops)
        torch.cuda.synchronize()
        assert K.launch_counts()[count] == 1
        lay = K.last_launch()
        split = B <= 33
        assert lay["staged"] and (lay["slices"] > 1) == split, (B, lay)
        assert bool(lay["zeroed"]) == split, (B, lay)
        want, oracle = plain(x, *ops), apply_hard(art.frozen, x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0], oracle), (B, lay)
    eng = ServingEngine(art, device="cuda", max_bucket=4096, n_train=2000)
    assert eng.bit_exact == {"fused-packed": True, "packed-eager": True}
    for b in eng.scheduler.buckets:
        eng.model.tuned_configs[b] = FusedConfig(variant, block_b=32)
    K.reset_launch_counts()
    for size in (1, 33, 4096):
        eng.submit(eng.make_request(size, seed=size))
    done = eng.drain()
    assert K.launch_counts()[count] >= 3
    for r in done:
        x = torch.from_numpy(np.ascontiguousarray(r.payload)).cuda()
        np.testing.assert_array_equal(r.result[0],
                                      apply_hard(art.frozen, x).cpu().numpy())


@pytest.mark.parametrize("variant,bits", [("TEN", None), ("PEN", 9)])
def test_verify_rtl_on_a_frozen_model_of_cuda_tensors(variant, bits):
    """A ``FrozenDWN`` whose arrays are tensors on the card: its cost
    report and Verilog equal the host model's, and ``verify_rtl`` runs the
    oracle on the card and passes on 256 vectors, per-class counts
    included."""
    _need_card()
    import dataclasses
    from repro_torch.dwn import DWNArtifact, get_spec
    from repro_torch.hw import cost, cosim, verilog
    from repro_torch.workloads import load_workload
    data = load_workload("mnist", 2000, 256, seed=0)
    spec = dataclasses.replace(get_spec("dwn-mnist-sm"), variant=variant,
                               input_bits=bits)
    f = DWNArtifact(spec).fit(data.x_train, seed=0).freeze().frozen
    on_card = dataclasses.replace(
        f, thresholds=torch.from_numpy(f.thresholds).cuda(),
        mapping_idx=[torch.from_numpy(i).cuda() for i in f.mapping_idx],
        tables_bin=[torch.from_numpy(t).cuda() for t in f.tables_bin])
    assert cost.dwn_hw_report(on_card, variant=variant, name="mnist-sm",
                              input_bits=bits).luts == \
        cost.dwn_hw_report(f, variant=variant, name="mnist-sm",
                           input_bits=bits).luts
    assert verilog.emit_dwn(on_card) == verilog.emit_dwn(f)
    rep = cosim.verify_rtl(on_card, data.x_test[:256], backend="python")
    assert rep.counts_checked and rep.n_vectors == 256
    assert rep.variant == variant


def test_supervisor_resumes_card_state_on_the_card(tmp_path):
    """A supervised run whose state lives on the card, with one injected
    crash: every step, the restored ones included, sees the state on the
    card, and the result equals the clean run's."""
    _need_card()
    from repro_torch.runtime.fault import (FaultInjector, RestartPolicy,
                                           Supervisor)

    def run(d, crash_steps):
        inj, devices = FaultInjector(crash_steps), []

        def step(handle):
            inj.maybe_crash(handle.step)
            devices.append(handle.state["w"].device.type)
            handle.state = {"w": handle.state["w"] * 2 + 1}
            handle.step += 1
            return handle
        sup = Supervisor(str(d), save_every=2,
                         policy=RestartPolicy(max_restarts=3, backoff_s=0))
        h = sup.run(step, init_state={"w": torch.arange(4.0, device="cuda")},
                    total_steps=7)
        return h, sup.restarts, devices

    clean, _, _ = run(tmp_path / "clean", set())
    h, restarts, devices = run(tmp_path / "faulty", {5})
    assert restarts == 1 and h.step == clean.step == 7
    assert set(devices) == {"cuda"} and h.state["w"].is_cuda
    assert torch.equal(h.state["w"], clean.state["w"])


def test_sweep_tiny_grid_on_the_card_equals_the_cpu():
    """The ``tiny`` grid on the card with the kernel and serve axes: every
    hardware field and the accuracy equal the CPU run's; ``kernel_us`` and
    the served samples/s are positive; the timed calls and served steps
    launched K2 (one launch per timed call, the first untimed one
    included, plus the served steps' replays)."""
    _need_card()
    import dataclasses
    from repro_torch.sweep import SweepSettings, run_grid
    from repro_torch.sweep.results import EXACT_FIELDS
    card = SweepSettings(n_train=512, n_test=256, kernel=True, serve=True,
                         kernel_iters=2, serve_batch=32)
    cpu = dataclasses.replace(card, device="cpu", kernel=False,
                              serve=False)
    K.reset_launch_counts()
    got = run_grid("tiny", card, cache_dir=None)
    launched = K.launch_counts()
    want = run_grid("tiny", cpu, cache_dir=None)
    for a, b in zip(got.points, want.points):
        assert a.point == b.point
        for f in EXACT_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.point.label, f)
        assert a.kernel_us > 0 and a.kernel_batch == 256
        assert a.serve_throughput > 0 and a.serve_backend == "fused-packed"
    n = len(got.points)
    assert launched["fused_dwn_packed"] >= n * (1 + card.kernel_iters
                                                + card.serve_requests)
    assert got.settings["device"] == "cuda"


def test_lm_train_steps_on_the_card_match_the_cpu():
    """Three ``make_train_step`` steps of the reduced qwen3-8b (float32
    master weights, ``masked`` attention) on the card from the CPU's init
    and ``TokenStream`` batches: per-step loss within 1e-3 and grad norm
    within 5e-3 relative of the CPU's (bf16 products on another device
    round differently), every parameter within 3 * lr * steps of the
    CPU's, all on the card and finite."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import api, transformer
    from repro_torch.optim.adam import leaves, map_tree
    cfg = get_arch("qwen3-8b").reduced()
    init = transformer.init_params(cfg, seed=0, dtype=torch.float32)
    runs = {}
    for dev in ("cpu", "cuda"):
        step, opt = api.make_train_step(cfg)
        params = map_tree(lambda t: t.to(dev, copy=True), init)
        state = opt.init(params)
        stream, hist = TokenStream(cfg.vocab_size, 32, 4, seed=0), []
        for _ in range(3):
            raw = stream.next_batch()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
            params, state, m = step(params, state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = (params, hist)
    (cp, ch), (gp, gh) = runs["cpu"], runs["cuda"]
    for (cl, cn), (gl, gn) in zip(ch, gh):
        assert abs(gl - cl) <= 1e-3 * cl and abs(gn - cn) <= 5e-3 * cn
    for a, b in zip(leaves(cp), leaves(gp)):
        assert b.is_cuda and bool(torch.isfinite(b).all())
        assert float((a - b.cpu()).abs().max()) <= 3 * 3e-4 * 3


def test_dwn_head_on_the_card_is_bit_exact_to_apply_hard():
    """dwn-lm-head fitted on an lm-head split made on the card, served as
    the head of a reduced qwen3-8b engine on the card: the startup gate
    holds, a classify request's counts equal ``apply_hard`` on the
    features it returned, and the head ran K2 once a request (replays of
    the 8-row step the startup gate captured)."""
    _need_card()
    from repro_torch.core.model import apply_hard
    from repro_torch.dwn import DWNArtifact, resolve_spec
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads import load_workload
    data = load_workload("lm-head", 96, 32, seed=0, device="cuda")
    art = DWNArtifact(resolve_spec("dwn-lm-head")).fit(data.x_train)
    art.freeze().pack("cuda")
    eng = ServingEngine("qwen3-8b", reduced=True, prompt_len=8, gen=2,
                        device="cuda", dwn_head=art)
    assert eng.head_bit_exact is True
    K.reset_launch_counts()
    for seed in (1, 2):
        eng.submit(eng.make_request(8, seed=seed, classify=True))
    eng.submit(eng.make_request(2, seed=3))
    done = eng.drain()
    assert K.launch_counts()["fused_dwn_packed"] == 2
    for r in done[:2]:
        feats = torch.from_numpy(r.result["features"]).cuda()
        want = apply_hard(art.frozen, feats).cpu().numpy()
        np.testing.assert_array_equal(r.result["counts"], want)
        np.testing.assert_array_equal(r.result["pred"], want.argmax(-1))
    rep = eng.report()["dwn_head"]
    assert rep["served"] == 16 and rep["cuda_graphs"] is True


@pytest.mark.parametrize("datapath", ["corner", "gather"])
def test_dwn_arch_prefill_on_the_card_equals_k2(datapath):
    """Exact: ``dwn_arch``'s prefill of 4096 samples at lg-2400 (contig
    and strided) equals K2 serving the same params
    (``dwn_arch.artifact``, a CUDA graph of the fused-packed backend),
    whose replay launches K2 once."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import api, dwn_arch
    from repro_torch.serving.backends import BoundBackend, get_backend
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4096, 16), dtype=np.float32)
                         * 0.7).cuda()
    for grouping in ("contig", "strided"):
        cfg = dataclasses.replace(get_arch("dwn-jsc-lg2400"),
                                  dwn_datapath=datapath,
                                  dwn_grouping=grouping)
        params = dwn_arch.init_params(torch.Generator().manual_seed(5), cfg,
                                      device="cuda")
        counts, _ = api.make_prefill(cfg)(params, {"features": x})
        art = dwn_arch.artifact(params, cfg).pack("cuda")
        bound = BoundBackend(get_backend("fused-packed"),
                             art.serving_model())
        bound(x)                       # captures the step's graph
        K.reset_launch_counts()
        want, _ = bound(x)
        assert K.launch_counts()["fused_dwn_packed"] == 1
        assert torch.equal(counts, want)


def test_dwn_arch_train_step_on_the_card_matches_the_cpu():
    """One ``make_train_step(num_micro=4)`` step at lg-2400 on 4 x 256
    samples: the card's loss, grad norm and params within 1e-5 of the
    CPU's from the same params (float32 products without TF32)."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.models import api, dwn_arch
    cfg = get_arch("dwn-jsc-lg2400")
    params = dwn_arch.init_params(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(2)
    batch = {"features": torch.from_numpy(rng.standard_normal(
                 (4, 256, 16), dtype=np.float32) * 0.7),
             "labels": torch.from_numpy(
                 rng.integers(0, 5, (4, 256)).astype(np.int32))}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.to(dev).clone() for k, v in params.items()}
            step, opt = api.make_train_step(cfg, num_micro=4)
            p, _, m = step(p, opt.init(p),
                           {k: v.to(dev) for k, v in batch.items()})
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        {k: v.cpu() for k, v in p.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-5
    assert abs(out["cuda"][1] - out["cpu"][1]) < 1e-5
    for k in params:
        assert (out["cuda"][2][k] - out["cpu"][2][k]).abs().max() < 1e-5, k


def test_dryrun_terms_bound_a_reduced_depth_qwen3_prefill_on_the_card():
    """qwen3-8b at full width cut to 4 layers (bf16 weights from a seed,
    ``masked`` attention): a prefill of 2 x 1024 tokens timed on the card
    (the best of 5, each ending in a synchronize) takes at least its
    dry-run's compute term and its argument bytes over HBM's rate, priced
    on a (1, 1) mesh on the meta device (``launch.dryrun.analyze_cell``
    with ``serve_bf16``, the reference's serving form: every param in
    bf16, where the card keeps its norm scales float32); the argument
    bytes are those params' and the tokens'."""
    _need_card()
    import dataclasses
    import time

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.models import api, transformer
    from repro_torch.optim.adam import leaves
    from repro_torch.sharding import AbstractMesh
    cfg = dataclasses.replace(get_arch("qwen3-8b"), num_layers=4)
    B, S = 2, 1024
    params = transformer.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda")}
    prefill = api.make_prefill(cfg, cache_len=S)
    prefill(params, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec = dryrun.analyze_cell(cfg, ShapeConfig("p", S, B, "prefill"),
                              AbstractMesh(("data", "model"), (1, 1)),
                              variants={"serve_bf16"})
    arg = rec["memory_analysis"]["argument_bytes"]
    assert arg == sum(2 * t.numel() for t in leaves(params)) + 4 * B * S
    assert min(times) >= rec["roofline"]["compute_s"] > 0
    assert min(times) >= arg / HBM_BW


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_mesh_prefill_at_world_one_over_nccl_equals_meshless():
    """The reduced qwen3-8b under ``pallas`` on a one-rank NCCL group's
    (1, 1) ("data", "model") mesh (params as DTensors,
    ``api.make_prefill(mesh=)``): its prefill's last logits and two decode
    steps' equal to the meshless path's on the same params, bit for bit
    (one rank runs no collective), with one flash-attention launch a
    layer in the prefill."""
    _need_card()
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, transformer
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(),
                              attn_impl="pallas", head_dim=128)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        params = transformer.init_params(cfg, seed=0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                             device="cuda")
        want, wcache = api.make_prefill(cfg, cache_len=42)(
            params, {"tokens": toks})
        sharded = api.shard_params(cfg, params, mesh)
        FK.reset_launch_counts()
        got, cache = api.make_prefill(cfg, cache_len=42, mesh=mesh)(
            sharded, {"tokens": toks})
        torch.cuda.synchronize()
        assert FK.launch_counts()["flash_attention"] == cfg.num_layers
        assert torch.equal(got, want)
        for t in range(2):
            nxt = {"tokens": want[:, :cfg.vocab_size].argmax(-1)[:, None]}
            got, cache = api.make_decode_step(cfg, mesh=mesh)(
                sharded, cache, nxt)
            want, wcache = api.make_decode_step(cfg)(params, wcache, nxt)
            assert torch.equal(got, want), t
    finally:
        dist.destroy_process_group()


def test_moe_ep_on_the_card_matches_ep_false():
    """The reduced granite-moe under ``pallas`` with ``moe_ep=True`` (its
    4 experts padded to 16, the float32 scatter-add combine) on the card:
    prefill's last logits within 0.05 relative of ``ep=False`` on the
    same live experts and router columns."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import api, transformer
    base = dataclasses.replace(get_arch("granite-moe-3b-a800m").reduced(),
                               attn_impl="pallas", head_dim=64)
    ep = dataclasses.replace(base, moe_ep=True)
    params = transformer.init_params(ep, seed=0, device="cuda")
    plain = {**params, "layers": [
        {**lp, "moe": {k: (v[:, :base.num_experts] if k == "router"
                           else v[:base.num_experts])
                       for k, v in lp["moe"].items()}}
        for lp in params["layers"]]}
    toks = torch.randint(0, base.vocab_size, (2, 40), device="cuda")
    got, _ = api.make_prefill(ep, cache_len=40)(params, {"tokens": toks})
    want, _ = api.make_prefill(base, cache_len=40)(plain, {"tokens": toks})
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert params["layers"][0]["moe"]["w_gate"].shape[0] == 16
    assert float(err) < 0.05, float(err)


# -- every shape the reference's kernels take --------------------------------

#: (F, T, LUTs a layer, fan-in, classes, variant) of K1/K2 launches whose
#: features or activations do not fit a block (the global scratch) or
#: whose stack passes INLINE_LAYERS: jsc-lg at a 4096-threshold encoder
#: (K2), two 1000-word hidden layers, 784 features, twelve layers, a
#: deep stack of fan-in-16 LUTs, and 2048 classes (their counts in the
#: scratch too)
WIDE_CASES = [(16, 4096, (2400,), 6, 5, "packed"),
              (16, 200, (32000, 32000, 2400), 6, 5, "packed"),
              (16, 200, (32000, 32000, 2400), 6, 5, "batch-major"),
              (784, 16, (8000, 1280), 6, 10, "packed"),
              (784, 16, (8000, 1280), 6, 10, "batch-major"),
              (16, 200, (2400,) * 12, 6, 5, "packed"),
              (16, 200, (2400,) * 12, 6, 5, "batch-major"),
              (16, 200, (96,) * 10, 16, 3, "batch-major"),
              (16, 200, (4096,), 6, 2048, "packed")]


@pytest.mark.parametrize("F,T,counts,n,C,variant", WIDE_CASES)
def test_cuda_fused_scratch_and_deep_stacks_match_plain(F, T, counts, n, C,
                                                        variant):
    """Exact at B = 1000, 33 and 1 (and 4097 for the one-layer shapes):
    the scratch path where ``check_activation_width`` plans it (reported
    by ``last_launch()["scratch"]``), any depth (the layers past
    ``INLINE_LAYERS`` read from device memory, ``device_layers``), equal
    to the plain version and, through a CUDA graph replay, to the eager
    call.  The scratch's blocks: one an SM at most, or every tile times
    its slices below as many tiles as SMs."""
    _need_card()
    kern, plain, name = _fused_kernel(variant)
    x, th, maps, tabs = _model(300 + len(counts), F, T, counts, n=n, B=4097)
    ops = tops.prepare_operands(
        torch.from_numpy(th).cuda(),
        [torch.from_numpy(a).cuda() for a in maps],
        [torch.from_numpy(a).cuda() for a in tabs], C, variant)
    path = K.check_activation_width(variant, F, T if variant == "packed"
                                    else 0, counts, C)
    for B in ((4097, 1000, 33, 1) if len(counts) == 1 else (1000, 33, 1)):
        xd = torch.from_numpy(x[:B]).cuda()
        got = kern(xd, *ops)
        lay = K.last_launch()
        assert lay["scratch"] == (path == "global")
        assert lay["device_layers"] == max(
            0, len(counts) - K.INLINE_LAYERS), lay
        ref = plain(xd, *ops)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    graphed = _replayed(lambda: kern(xd, *ops))
    assert torch.equal(graphed[0], got[0]) and torch.equal(graphed[1],
                                                           got[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    W_last = counts[-1] // 32
    assert K.scratch_blocks(32 * sms, W_last) == sms
    assert K.scratch_blocks(10 ** 6, W_last) == sms
    assert K.scratch_blocks(1, W_last) == min(W_last, sms)
    assert K.scratch_blocks(33, W_last) <= sms + 1


@pytest.mark.parametrize("F,n", [(16, 10), (16, 16), (3000, 6),
                                 (60_000, 9)])
def test_cuda_fused_dwn_global_path_matches_plain(F, n):
    """K6 where no block holds its slices (fan-in 10 and 16) or its rows
    (60,000 features, fan-in 9: the tile's features read from global
    memory too): the global path, exact on {0,1} tables at B = 4097, 33
    and 1; F = 3000 at fan-in 6 stays on the rows kernel."""
    _need_card()
    x, th, maps, tabs = _model(310 + n, F, 2, (480,), n=n, B=4097)
    xd, thd = torch.from_numpy(x).cuda(), torch.from_numpy(th).cuda()
    mp = torch.from_numpy(maps[0]).cuda()
    tab = torch.from_numpy(tabs[0]).cuda().float()
    for B in (4097, 33, 1):
        got = K.fused_dwn(xd[:B], thd, mp, tab, 5)
        lay = K.last_float_launch()
        assert lay["path"] == ("rows" if n <= 8 and F <= 10_000
                               else "global"), lay
        assert lay["smem_bytes"] == (128 * F if 128 * F <= K.MAX_SMEM_BYTES
                                     else 0) or lay["path"] == "rows"
        ref = R.fused_dwn_plain(xd[:B], thd, mp, tab, 5)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("C,n", [(3200, 9), (3200, 12), (480, 16),
                                 (65_536, 6), (60_000, 3)])
def test_cuda_lut_eval_wide_matches_plain(C, n):
    """K8's wide kernel at fan-in 9 to 16 and on rows past 58,112 bits:
    bit-exact to the plain version on {0,1} bits (the same lerps in the
    same order), soft bits within 1e-5."""
    _need_card()
    rng = np.random.default_rng(320 + n)
    m = 96 if n == 16 else 300
    mp = torch.from_numpy(rng.integers(0, C, (m, n)).astype(np.int32)).cuda()
    tab = torch.from_numpy(rng.integers(0, 2, (m, 2 ** n)).astype(
        np.float32)).cuda()
    tab_t = tab.T.contiguous()
    for B in (33, 1) if n == 16 else (257, 33, 1):
        bits = torch.from_numpy(rng.integers(0, 2, (B, C)).astype(
            np.float32)).cuda()
        got = KL.lut_eval(bits, mp, tab_t)
        assert KL.last_float_launch()["path"] == "global"
        assert torch.equal(got, RL.lut_eval_plain(bits, mp, tab))
    soft = torch.from_numpy(rng.uniform(0, 1, (5, C)).astype(
        np.float32)).cuda()
    torch.testing.assert_close(KL.lut_eval(soft, mp, tab_t),
                               RL.lut_eval_plain(soft, mp, tab), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n", [6, 16])
def test_cuda_lut_eval_packed_global_rows_match_plain(n):
    """K4 on rows past the rows kernel's 7264 words (8192 words, as K3
    packs F = 16 at T = 16,384): each row read from global memory, exact
    at B = 4097, 33 and 1."""
    _need_card()
    rng = np.random.default_rng(330 + n)
    W_in, m = 8192, 256
    wires = torch.from_numpy(rng.integers(0, 32 * W_in, (m, n)).astype(
        np.int32)).cuda()
    tab = R.pack_table_words(torch.from_numpy(
        rng.integers(0, 2, (m, 2 ** n))).cuda())
    for B in (4097, 33, 1):
        words = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (B, W_in), dtype=np.int64).astype(
                np.int32)).cuda()
        got = KL.lut_eval_packed(words, wires >> 5, wires & 31, tab)
        assert KL.last_launch()["path"] == "global"
        want = RL.lut_eval_packed_plain(words, wires >> 5, wires & 31, tab)
        assert torch.equal(tbp.from_word_pattern(got), want)


@pytest.mark.parametrize("hd", [1, 8, 17, 32, 40, 50, 80, 100, 104, 200,
                                256])
def test_flash_attention_any_head_dim_matches_plain_on_card(hd):
    """Every head dim up to 256 on the smallest instance at or above it
    (``instance_for``), its columns past hd zeros and its scale hd's own:
    within 2e-2 of the plain version, causal and not, GQA 8:2, S = 1, 65
    and 300; per row within 1e-2 from hd 32 on, within 2e-2 from hd 8 (a
    row of fewer values has too few for its largest to scale the bar)."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn.ref import attention_ref
    _need_card()
    for i, S in enumerate((1, 65, 300)):
        q, k, v = (t.bfloat16() for t in _attn_operands(hd + i, 2, S, 8, 2,
                                                        hd))
        for causal in (True, False):
            got = FK.flash_attention(q, k, v, causal=causal)
            exact = attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal)
            torch.testing.assert_close(got.float(), exact, atol=FLASH_TOL,
                                       rtol=FLASH_TOL)
            if hd >= 8:
                row = ((got.float() - exact).abs().amax(-1)
                       / exact.abs().amax(-1).clamp_min(1e-30))
                bar = FLASH_ROW_REL if hd >= 32 else FLASH_ROW_REL_NARROW
                assert float(row.max()) <= bar, (hd, S, causal)
