"""Host-side layout of the tile kernels K6 (``fused_dwn``), K4
(``lut_eval_packed``), K8 (``lut_eval``), K3
(``thermometer_encode_packed``) and K5 (``popcount_classify_packed``):
the slice plans, the choice between the
tile kernels and the rows kernels kept for shapes a tile does not fit,
the widths each wrapper accepts, the rounding of ``block_b`` and
``block_m``, the combine kernel's plain version and the build hash of the
device code the kernel libraries share.

Everything here runs on the CPU: the plans are plain Python that the
wrappers compute before any launch, given the card's SM count.  The
kernels themselves are held to their plain versions on the card by
``test_torch_gpu.py``.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels._launch import align16  # noqa: E402
from repro_torch.kernels.autotune import FusedConfig  # noqa: E402
from repro_torch.kernels.fused import kernel as K  # noqa: E402
from repro_torch.kernels.fused import ref as R  # noqa: E402
from repro_torch.kernels.lut_eval import kernel as KL  # noqa: E402
from repro_torch.kernels.popcount import kernel as KP  # noqa: E402
from repro_torch.kernels.thermometer import kernel as KT  # noqa: E402

SMS = 132                      # an H100's streaming multiprocessors
MAX = K.MAX_SMEM_BYTES


def _pr13_accepts(B, F, C, n, block_b, block_m, m):
    """The float rows kernel's one refusal: its block's shared memory."""
    bb, bm = min(block_b, B), min(block_m, m)
    return 4 * (bm * (2 ** n + 2 * n) + bb * (F + 32 * C)) <= MAX


def _chunks_of_class(m, C):
    g = m // C
    cpc = -(-g // 32)
    return g, cpc


@pytest.mark.parametrize("B", [1, 31, 33, 64, 1000, 1024, 4096, 4097])
def test_float_slices_cover_every_chunk_once_at_class_groups(B):
    """At lg-2400 (5 groups of 480 LUTs, 15 chunks each) every counted
    chunk lies in exactly one slice, and a slice is whole class groups or
    a piece of one group, never parts of two."""
    plan = K.plan_fused_dwn(B, 16, 2400, 6, 5, K.FUSED_DWN_BLOCK_B,
                            None, SMS)
    assert plan.path == "tiles" and plan.chunks == 75
    covered = [c for c0, c1 in plan.slice_ranges() for c in range(c0, c1)]
    assert sorted(covered) == list(range(75))
    for c0, c1 in plan.slice_ranges():
        whole = c0 % 15 == 0 and c1 % 15 == 0
        assert whole or c0 // 15 == (c1 - 1) // 15, (c0, c1)
    assert plan.smem_bytes <= MAX


def test_float_slices_are_one_class_group_at_full_batches():
    """From 1000 samples on, lg-2400's slice is one class group (480 LUTs,
    146 KB of tables and wires): one block owns whole class sums."""
    for B in (1000, 4096, 4097):
        plan = K.plan_fused_dwn(B, 16, 2400, 6, 5, K.FUSED_DWN_BLOCK_B,
                                None, SMS)
        assert plan.slice_ranges() == [(0, 15), (15, 30), (30, 45),
                                       (45, 60), (60, 75)]
        assert plan.tile_rows == 32 and plan.block_m == 480


@pytest.mark.parametrize("B,slices", [(1, 75), (64, 75), (1024, 5),
                                      (4096, 5)])
def test_float_slices_split_to_fill_the_card(B, slices):
    """Below 132 tiles of 32 the slices narrow (pieces of a class group,
    down to one chunk) until tiles x slices fill the card, as K1 and K2
    split their last layer."""
    plan = K.plan_fused_dwn(B, 16, 2400, 6, 5, K.FUSED_DWN_BLOCK_B,
                            None, SMS)
    tiles = -(-B // plan.tile_rows)
    assert plan.slices == slices
    assert tiles * plan.slices >= min(SMS, tiles * plan.chunks) * 0.5


def test_float_plan_layout_is_sound():
    """For any shape the plan's slices cover every counted chunk exactly
    once, keep to whole groups or pieces of one, and fit a block."""
    for m, C, n, block_m, B in itertools.product(
            (40, 130, 600, 2402), (1, 3, 5, 10), (1, 6, 8), (1, 32, 100, None),
            (1, 200, 4096)):
        plan = K.plan_fused_dwn(B, 16, m, n, C, 32, block_m, SMS)
        g, cpc = _chunks_of_class(m, C)
        assert plan.chunks == C * cpc
        covered = sorted(c for c0, c1 in plan.slice_ranges()
                         for c in range(c0, c1))
        assert covered == list(range(plan.chunks)), (m, C, n, block_m, B)
        for c0, c1 in plan.slice_ranges():
            if c1 > c0 and cpc:
                assert (c0 % cpc == 0 and c1 % cpc == 0) or \
                    c0 // cpc == (c1 - 1) // cpc
        assert plan.smem_bytes <= MAX
        if block_m is not None:
            assert plan.cs * 32 <= max(32, block_m // 32 * 32)


@pytest.mark.parametrize("block_b,block_m,rows,luts", [
    (1, 1, 32, 32), (7, 7, 32, 32), (33, 100, 64, 96), (64, 128, 64, 128),
    (4096, 480, 672, 32), (32, 512, 32, 480), (32, None, 32, 480),
    (4096, None, 672, 32)])
def test_float_plan_rounds_block_b_and_block_m(block_b, block_m, rows,
                                               luts):
    """``block_b`` rounds up to a multiple of 32 and down to what fits;
    ``block_m`` rounds down to whole chunks of 32 (at least one), then to
    whole class groups, or equal pieces of one (lg-2400, B = 1000; two
    tiles of 672 are cut to one-chunk slices to fill the card); None
    takes as many as fit.  A ``block_m`` whose LUTs alone exceed a block,
    once refused, takes the global path: tiles of 32, the tables read
    from global memory, at most ``block_m`` LUTs a slice."""
    plan = K.plan_fused_dwn(1000, 16, 2400, 6, 5, block_b, block_m, SMS)
    assert (plan.path, plan.tile_rows, plan.block_m) == \
        ("tiles", rows, luts)
    wide = K.plan_fused_dwn(1000, 16, 2400, 6, 5, block_b, 2400, SMS)
    assert (wide.path, wide.tile_rows, wide.smem_bytes) == \
        ("global", 32, 16 * 128)
    assert wide.block_m <= 2400 and wide.slices * wide.cs >= wide.chunks


@pytest.mark.parametrize("F,n,m,block_m", [
    (16, 1, 10000, 7000), (454, 1, 10000, 7000), (454, 8, 2400, 200),
    (16, 6, 2400, 764), (200, 1, 50_000, 14_000)])
def test_float_plan_caps_a_wide_block_m_to_what_fits(F, n, m, block_m):
    """The path follows the shapes alone: an explicit ``block_m`` wider
    than a tile block holds beside the features is cut to the widest
    slice that fits, and the launch stays on the tiles path (the rows
    kernel would take it, three times slower)."""
    fit = (MAX - 2 * F * 128) // (32 * (4 * 2 ** n + 48))
    for B in (1, 1000, 4096):
        plan = K.plan_fused_dwn(B, F, m, n, 5, 32, block_m, SMS)
        assert plan.path == "tiles", (B, plan)
        assert plan.cs <= fit and plan.smem_bytes <= MAX
        assert plan.block_m <= block_m


def test_float_plan_path_depends_on_the_features_only():
    """Over widths, fan-ins, tile rows and slice widths, every launch
    whose ``block_m`` fits a block takes the tiles path for F <= 454 and
    the rows kernel above; one whose ``block_m`` does not (once refused)
    the global path."""
    for F, n, bb, bm in itertools.product(
            (1, 16, 454, 455, 3000), range(1, 9), (1, 32, 4096),
            (1, 128, 480, 700, None)):
        plan = K.plan_fused_dwn(1000, F, 2400, n, 5, bb, bm, SMS)
        if bm is not None and bm * 4 * (2 ** n + 2 * n) > MAX:
            assert plan.path == "global", (F, n, bb, bm)
            continue
        assert plan.path == ("tiles" if F <= 454 else "rows"), (F, n, bb, bm)


def test_fused_config_block_m_reaches_the_plan():
    """The reference's FusedConfig default (block_b 32, block_m 128) cuts
    lg-2400 into slices of 4 chunks, pieces of a class group."""
    cfg = FusedConfig()
    plan = K.plan_fused_dwn(4096, 16, 2400, 6, 5, cfg.block_b, cfg.block_m,
                            SMS)
    assert (plan.tile_rows, plan.cs, plan.block_m) == (32, 4, 128)
    assert all(c1 - c0 <= 4 for c0, c1 in plan.slice_ranges())


@pytest.mark.parametrize("n", range(1, 9))
def test_float_plan_takes_every_fan_in(n):
    """Every fan-in from 1 to 8 takes the tiles path at lg width with the
    kernel's defaults (slices cut to pieces of a class group where one
    does not fit: fan-in 7 and 8), and with the FusedConfig default."""
    for block_m in (None, FusedConfig().block_m):
        plan = K.plan_fused_dwn(4096, 16, 2400, n, 5, 32, block_m, SMS)
        assert plan.path == "tiles" and plan.smem_bytes <= MAX
        assert plan.ppc == 1 or n >= 7 or block_m is not None


@pytest.mark.parametrize("F,path", [(16, "tiles"), (196, "tiles"),
                                    (454, "tiles"), (455, "rows"),
                                    (2000, "rows")])
def test_float_plan_sends_wide_features_to_the_rows_kernel(F, path):
    """Two tiles of 32 samples' features may take half a block: wider
    features take the rows kernel with its own block_b and block_m."""
    plan = K.plan_fused_dwn(1000, F, 2400, 6, 5, 16, 64, SMS)
    assert plan.path == path
    if path == "rows":
        assert (plan.tile_rows, plan.block_m) == (16, 64)
        widest = K.plan_fused_dwn(1000, F, 2400, 6, 5, 16, None, SMS)
        assert widest.block_m > 64 and widest.smem_bytes <= MAX


def test_float_plan_accepts_whatever_pr13_accepted():
    """No operand the rows kernel alone took is refused: over a grid of
    widths, fan-ins and tile sizes, every launch is planned, each one the
    rows kernel took on the tiles or rows path as before; a block that
    did not fit (900 fan-in-8 LUTs a step, once refused) takes the global
    path."""
    for F, n, bb, bm, m in itertools.product(
            (1, 16, 300, 454, 455, 5000, 40_000), range(1, 9),
            (1, 16, 32, 256, 4096), (1, 32, 128, 256, 900), (64, 2400)):
        accepted = _pr13_accepts(1000, F, 5, n, bb, bm, m)
        plan = K.plan_fused_dwn(1000, F, m, n, 5, bb, bm, SMS)
        assert not accepted or plan.path != "global", (F, n, bb, bm, m)
    plan = K.plan_fused_dwn(8, 16, 900, 8, 5, K.FUSED_DWN_BLOCK_B, 900, SMS)
    assert (plan.path, plan.slices, plan.cs, plan.smem_bytes) == \
        ("global", 30, 1, 16 * 128)


def test_float_plan_without_counted_luts():
    """m < C: no LUT counts for a class; one empty slice, counts 0."""
    plan = K.plan_fused_dwn(9, 16, 4, 6, 5, 32, 512, SMS)
    assert plan.chunks == 0 and plan.slices == 1
    assert plan.slice_ranges() == [(0, 0)]


def test_combine_plain_adds_chunks_in_order():
    """``fused_dwn_combine_plain``: class c's count is 0 + its chunk sums
    in chunk order, in float32 (the kernel's rounding), first argmax;
    the CPU wrapper runs it."""
    rng = np.random.default_rng(0)
    part = rng.uniform(-1e4, 1e4, (30, 7)).astype(np.float32)
    counts, idx = K.fused_dwn_combine(torch.from_numpy(part), 5)
    for c in range(5):
        s = np.zeros(7, np.float32)
        for k in range(6):
            s = (s + part[c * 6 + k]).astype(np.float32)
        assert np.array_equal(counts[:, c].numpy(), s)
    assert np.array_equal(idx.numpy(), counts.numpy().argmax(-1))
    tie = torch.ones((10, 3))
    assert K.fused_dwn_combine(tie, 5)[1].tolist() == [0, 0, 0]


@pytest.mark.parametrize("m,C", [(2400, 5), (2402, 5), (130, 5), (70, 3)])
def test_chunk_sums_give_the_plain_counts(m, C):
    """The kernel's chunking (class c's chunk k: LUTs c*g + 32k onwards,
    at most 32, never past the group) then the combine equals
    ``fused_dwn_plain`` exactly on {0,1} tables and within 1e-4 on float
    tables."""
    rng = np.random.default_rng(m)
    F, T, n, B = 16, 20, 6, 50
    x = torch.from_numpy(rng.uniform(-1, 1, (B, F)).astype(np.float32))
    th = torch.from_numpy(np.sort(rng.uniform(-1, 1, (F, T)).astype(
        np.float32), axis=1))
    mp = torch.from_numpy(rng.integers(0, F * T, (m, n)).astype(np.int32))
    g, cpc = _chunks_of_class(m, C)
    for tab in (rng.integers(0, 2, (m, 2 ** n)),
                rng.uniform(-1, 1, (m, 2 ** n))):
        tab = torch.from_numpy(tab.astype(np.float32))
        bits = (x[:, :, None] > th).reshape(B, F * T).float()
        addr = sum(bits[:, mp[:, k].long()].long() << k for k in range(n))
        out = tab[torch.arange(m), addr]                     # (B, m)
        part = torch.zeros((C * cpc, B))
        for c in range(C):
            for k in range(cpc):
                acc = torch.zeros(B)
                for j in range(c * g + 32 * k, min(c * g + 32 * k + 32,
                                                   (c + 1) * g)):
                    acc = acc + out[:, j]
                part[c * cpc + k] = acc
        got = R.fused_dwn_combine_plain(part, C)
        ref = R.fused_dwn_plain(x, th, mp, tab, C)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
        if bool(((tab == 0) | (tab == 1)).all()):
            assert torch.equal(got[0], ref[0])
            assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("W_in,n,path", [
    (100, 1, "tiles"), (100, 6, "tiles"), (100, 10, "tiles"),
    (100, 15, "tiles"), (100, 16, "rows"), (454, 6, "tiles"),
    (455, 6, "rows"), (7264, 6, "rows")])
def test_packed_plan_paths(W_in, n, path):
    """K4 stages its layer per block where two 32-sample tiles of input
    words take at most half a block and a word of LUTs fits beside them;
    else the rows kernel (rows of up to 7264 words, fan-in 16)."""
    plan = KL.plan_lut_eval_packed(4096, W_in, 2400, n, SMS)
    assert plan.path == path and plan.smem_bytes <= MAX
    if path == "tiles":
        assert plan.slices * plan.slice_words >= 75
        assert (plan.slices - 1) * plan.slice_words < 75


def test_packed_plan_accepts_every_width_pr12_took():
    """Rows of up to 7264 words (8 warps' rows in a block) at any fan-in
    stage in shared memory as before; wider rows, once refused, are
    staged six a block by the block rows kernel (two groups of three) up
    to 58,112 words, and read from global memory by the first kernel
    past that."""
    for W_in, n in itertools.product((1, 100, 454, 455, 3000, 7264),
                                     (1, 6, 10, 16, 20)):
        assert KL.plan_lut_eval_packed(33, W_in, 256, n, SMS).path not in \
            ("global", "block_rows")
    assert KL.plan_lut_eval_packed(33, 7265, 256, 6, SMS) == \
        KL.PackedPlan("block_rows", 1, 8, 2 * align16(3 * 7265 * 4), 6)
    assert KL.plan_lut_eval_packed(33, 58_113, 256, 6, SMS) == \
        KL.PackedPlan("global", 1, 8, 0)


@pytest.mark.parametrize("B,slices", [(1, 75), (64, 38), (1024, 4),
                                      (4096, 1)])
def test_packed_plan_splits_words_to_fill_the_card(B, slices):
    """Below 132 tiles of 32 the layer's 75 words (lg-2400) are split
    over slices so that tiles x slices fill the card."""
    plan = KL.plan_lut_eval_packed(B, 100, 2400, 6, SMS)
    assert plan.slices == slices
    assert plan.slice_words == -(-75 // slices)


def test_shared_header_edits_rebuild_and_retune(monkeypatch):
    """``kernels/csrc/tiles.cuh`` is device code four kernel libraries
    include (the fused kernels', the LUT layers', the thermometer
    encode's and the popcount classify's): an edit to it changes their
    build hashes and the fused tuner's kernel fingerprint, and no other
    library's hash; it is not a library of its own."""
    srcs = _build.sources()
    assert "tiles" not in srcs
    assert (_build.SHARED_DIR / "tiles.cuh").is_file()
    before = {name: _build.library_path(srcs[name])
              for name in srcs}
    fp = autotune.kernel_fingerprint()
    read = _build.Path.read_bytes

    def edited(path):
        data = read(path)
        return data + b"//" if path.name == "tiles.cuh" else data
    monkeypatch.setattr(_build.Path, "read_bytes", edited)
    autotune.kernel_fingerprint.cache_clear()
    try:
        after = {name: _build.library_path(srcs[name]) for name in before}
        assert after["fused_dwn"] != before["fused_dwn"]
        assert after["lut_eval"] != before["lut_eval"]
        assert after["thermometer"] != before["thermometer"]
        assert after["popcount"] != before["popcount"]
        assert after["flash_attn"] == before["flash_attn"]
        assert autotune.kernel_fingerprint() != fp
    finally:
        monkeypatch.undo()
        autotune.kernel_fingerprint.cache_clear()
    assert autotune.kernel_fingerprint() == fp
    assert _build.library_path(srcs["fused_dwn"]) == before["fused_dwn"]


def _float_tile_bytes(C):
    """lut_eval_tiles_kernel's shared memory (float_tiles_bytes in
    ``lut_eval.cu``): 16 rows of C floats, each padded to a multiple of
    4 floats."""
    return 64 * (-(-C // 4) * 4)


@pytest.mark.parametrize("C,path", [
    (1, "tiles"), (21, "tiles"), (3200, "tiles"), (3629, "tiles"),
    (3632, "tiles"), (3633, "rows"), (20_000, "rows"), (58_112, "rows")])
def test_float_lut_plan_paths(C, path):
    """K8 takes a tile of 16 rows where it fits a block, else the rows
    kernel, whatever B and the fan-in are: the path follows C alone, and
    the plan's bytes are the C layout's."""
    for B in (1, 33, 1000, 4096, 4097):
        plan = KL.plan_lut_eval(B, C, 2400, SMS)
        assert plan.path == path, (B, plan)
        assert plan.smem_bytes <= MAX
        if path == "tiles":
            assert plan.rows == 16
            assert plan.smem_bytes == _float_tile_bytes(C)
        else:
            assert plan.rows == min(8, MAX // (4 * C))
            assert plan.smem_bytes == plan.rows * C * 4


def test_float_lut_plan_accepts_every_width_pr13_took():
    """The first float kernel took rows of up to 58,112 bits (one row a
    block); so does the plan, the tiles up to 3632 bits and the rows
    kernel above; wider rows, once refused, take the wide kernel, which
    reads them from global memory."""
    for C in (1, 100, 3200, 3632, 3633, 20_000, 29_056, 58_112):
        plan = KL.plan_lut_eval(100, C, 300, SMS)
        assert plan.path == ("tiles" if C <= 3632 else "rows"), C
    assert KL.plan_lut_eval(7, 29_056, 64, SMS).rows == 2
    assert KL.plan_lut_eval(7, 58_112, 64, SMS).rows == 1
    assert KL.plan_lut_eval(7, 58_113, 64, SMS) == \
        KL.FloatPlan("global", 1, 1, KL.WIDE_ROWS, 0)


@pytest.mark.parametrize("B,slices,per", [(1, 19, 1), (64, 19, 1),
                                          (1024, 2, 10), (4096, 1, 19),
                                          (4097, 1, 19)])
def test_float_lut_plan_splits_passes_to_fill_the_card(B, slices, per):
    """At lg-2400 (19 passes of 128 LUTs, the last three-quarters full) the
    passes are split over slices only below 132 tiles of 16 rows, so that
    tiles x slices fill the card; every pass lies in exactly one slice."""
    plan = KL.plan_lut_eval(B, 3200, 2400, SMS)
    assert (plan.path, plan.slices, plan.slice_passes) == \
        ("tiles", slices, per)
    assert (plan.slices - 1) * plan.slice_passes < 19 <= \
        plan.slices * plan.slice_passes
    tiles = -(-B // 16)
    assert tiles * plan.slices >= min(SMS, tiles * 19) * 0.5


def test_float_lut_plan_covers_every_pass_once():
    """For any m the slices cover the ceil(m/128) passes exactly once, with
    no slice empty (the C entry checks S == ceil(passes / per slice))."""
    for B, m, sms in itertools.product((1, 17, 500, 5000),
                                       (1, 127, 128, 129, 2400, 2402),
                                       (1, 132)):
        plan = KL.plan_lut_eval(B, 160, m, sms)
        passes = -(-m // 128)
        assert plan.slices == -(-passes // plan.slice_passes)
        assert plan.slices <= passes


def _encode_tile_bytes(F, ws):
    """thermometer_encode_packed_kernel's shared memory
    (encode_tiles_layout in ``thermometer.cu``): ws words of thresholds,
    the [ws][33] output tile, both 16-byte aligned, and two [F][32]
    feature buffers."""
    def a16(v):
        return (v + 15) // 16 * 16
    return a16(ws * 128) + a16(ws * 33 * 4) + 2 * F * 32 * 4


@pytest.mark.parametrize("B,slices,ws", [(1, 100, 1), (31, 100, 1),
                                         (64, 50, 2), (1024, 4, 25),
                                         (4096, 1, 100), (4097, 1, 100)])
def test_encode_plan_splits_words_to_fill_the_card(B, slices, ws):
    """K3 at lg width (F = 16, T = 200: 100 words) stages every threshold
    in one slice from 132 tiles of 32 samples on; below, the words are
    split so that tiles x slices fill the card."""
    plan = KT.plan_thermometer_encode_packed(B, 16, 200, SMS)
    assert (plan.path, plan.slices, plan.slice_words) == \
        ("tiles", slices, ws)
    assert plan.smem_bytes == _encode_tile_bytes(16, ws) <= MAX


@pytest.mark.parametrize("F,T,path", [
    (16, 200, "tiles"), (3, 7, "tiles"), (5, 13, "tiles"), (1, 1, "tiles"),
    (454, 4, "tiles"), (455, 4, "rows"), (2000, 1, "rows"),
    (16, 4000, "tiles"), (1, 2 ** 31 - 1, "rows")])
def test_encode_plan_paths(F, T, path):
    """K3 takes tiles of 32 samples where two tiles' features take at most
    half a block (F <= 454), else the first design, kept; the path follows
    F and T alone, and the plan's bytes are the C layout's."""
    for B in (1, 33, 4096):
        plan = KT.plan_thermometer_encode_packed(B, F, T, SMS)
        assert plan.path == path, (B, plan)
        if path == "tiles":
            assert plan.smem_bytes == _encode_tile_bytes(
                F, plan.slice_words) <= MAX


def test_encode_plan_slices_thresholds_too_large_for_a_block():
    """Thresholds of F*T = 64,000 bits (250 KB) do not fit one block: even
    at B = 4096 the 2000 words go in slices that do, each staged once per
    block; every word lies in exactly one slice."""
    plan = KT.plan_thermometer_encode_packed(4096, 16, 4000, SMS)
    W = 2000
    assert plan.path == "tiles" and plan.slices >= 2
    assert 4 * 16 * 4000 > MAX
    assert (plan.slices - 1) * plan.slice_words < W <= \
        plan.slices * plan.slice_words
    assert plan.smem_bytes <= MAX


def test_encode_plan_accepts_every_shape_pr12_took():
    """The first packed encode took any F, T and B; every shape gets a
    plan (the rows kernel where no tile fits), none raises."""
    for B, F, T in itertools.product((1, 32, 33, 4097), (1, 16, 454, 455,
                                                         5000),
                                     (1, 7, 200, 10_000)):
        plan = KT.plan_thermometer_encode_packed(B, F, T, SMS)
        assert plan.path in ("tiles", "rows")
        W = -(-F * T // 32)
        assert plan.slices * plan.slice_words >= W


def test_k8_and_k3_plans_are_made_once_per_shape():
    """The K8 and K3 wrappers look their plan up on every call: a shape
    planned before returns the same plan object, unplanned again."""
    for plan in (lambda: KL.plan_lut_eval(4096, 3200, 2400, SMS),
                 lambda: KT.plan_thermometer_encode_packed(4096, 16, 200,
                                                           SMS)):
        first = plan()
        assert plan() is first


def _popcount_tile_bytes(W, C):
    """popcount_classify_packed_kernel's shared memory
    (popcount_tiles_layout in ``popcount.cu``): the [C][W] masks and 16
    words of padding, rounded to 16 bytes, the tile's [C][32] counts and
    32 rows of W | 1 words, 4 bytes each."""
    return (-(-(C * W + 16) * 4 // 16) * 16 + 4 * C * 32
            + 4 * 32 * (W | 1))


@pytest.mark.parametrize("W,C,path,warps", [
    (75, 5, "tiles", 8), (2, 5, "tiles", 1), (7, 10, "tiles", 1),
    (63, 10, "tiles", 8), (17, 8, "tiles", 3), (0, 1, "tiles", 1),
    (75, 17, "tiles", 8), (75, 32, "tiles", 8), (1565, 5, "tiles", 8),
    (1566, 5, "rows", 0), (20_000, 5, "rows", 0), (75, 33, "rows", 0),
    (2, 100, "rows", 0)])
def test_popcount_plan_paths(W, C, path, warps):
    """K5 takes tiles of 32 samples where a block's shared memory holds a
    tile's rows beside the masks (W <= 1565 at C = 5) and C <= 32 (a
    warp's classes with a non-zero mask word are one 32-bit set), with
    one warp per 8 words up to 8; else the first design, kept; the plan's
    bytes are the C layout's."""
    plan = KP.plan_popcount_classify_packed(W, C)
    assert (plan.path, plan.warps) == (path, warps)
    if path == "tiles":
        assert plan.smem_bytes == _popcount_tile_bytes(W, C) <= MAX
        assert C <= KP.MAX_CLASSES
    else:
        assert plan.smem_bytes == 0
        assert C > KP.MAX_CLASSES or _popcount_tile_bytes(W, C) > MAX


def test_popcount_plan_accepts_every_shape_the_first_design_took():
    """The first packed classify took any W >= 0 and C >= 1 (and any B:
    the plan does not depend on it); every shape gets a plan, the tiles
    exactly where they fit, none raises."""
    for W, C in itertools.product((0, 1, 2, 31, 32, 75, 454, 1565, 1566,
                                   5000, 70_000), (1, 2, 5, 8, 9, 10, 16,
                                                   17, 32, 33, 1000)):
        plan = KP.plan_popcount_classify_packed(W, C)
        fits = C <= 32 and _popcount_tile_bytes(W, C) <= MAX
        assert plan.path == ("tiles" if fits else "rows"), (W, C, plan)


def test_k5_plan_is_made_once_per_shape():
    """The K5 wrapper looks its plan up on every call: a shape planned
    before returns the same plan object, unplanned again."""
    first = KP.plan_popcount_classify_packed(75, 5)
    assert KP.plan_popcount_classify_packed(75, 5) is first
    assert KP.plan_popcount_classify_packed.cache_info().hits >= 1


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", range(1, 9))
def test_k8_bound_counts_the_lerp_trees_float_operations(n):
    """K8's bound charges the float operations the lerp tree needs: walk
    the tree of one LUT, each lerp fma(s, hi - lo, lo); a difference of two
    table entries (the lowest level) is the LUT's alone, done once for all
    rows, every other operation once per row."""
    per_lut = per_row = 0
    level = ["table"] * 2 ** n
    while len(level) > 1:
        nxt = []
        for lo, hi in zip(level[::2], level[1::2]):
            if lo == hi == "table":
                per_lut += 1          # hi - lo
            else:
                per_row += 1
            per_row += 1              # the FMA with the row's input
            nxt.append("row")
        level = nxt
    B, m = 37, 50
    _, ops = _chip_smoke().model_bytes_and_ops(
        "float_lut_eval", B, 16, 200, (m,), n, 5)
    assert ops["fp32"] == B * m * per_row + m * per_lut
    assert ops["int"] == B * m * n


@pytest.mark.parametrize("shape,causal,bound_ms,bound_by,ex2_ms", [
    ((2, 1000, 8, 2, 32), True, 0.00104, "operations", 0.00191),
    ((4, 2048, 32, 8, 32), True, 0.0348, "operations", 0.0642),
    ((4, 2048, 10, 1, 256), True, 0.0869, "operations", 0.0201),
    ((2, 1000, 8, 2, 8), True, 0.000259, "operations", 0.00191),
    ((4, 2048, 24, 8, 64), True, 0.0521, "operations", 0.0482),
    ((4, 2048, 32, 8, 128), True, 0.139, "operations", 0.0642),
    ((8200, 64, 8, 8, 16), True, 0.160, "bytes", 0.0326),
    ((4, 2048, 32, 8, 16), True, 0.0174, "operations", 0.0642),
    ((2, 1000, 8, 2, 16), True, 0.000518, "operations", 0.00191),
    ((2, 1000, 8, 2, 32), False, 0.00207, "operations", 0.00383)])
def test_k10_bound_is_the_larger_of_bytes_and_products(
        shape, causal, bound_ms, bound_by, ex2_ms):
    """K10's bound is the larger of q, k, v and o at 3.35 TB/s and the two
    products' tensor-core operations at 989 TFLOP/s; one ex2 a score at
    16 a clock an SM on 132 SMs at 1980 MHz, the scores B·H·S(S+1)/2
    causal and B·H·S² not, is a term of its own (the special-function
    unit's floor) that sets no bound, even where it is the largest."""
    B, S, H, KH, hd = shape
    cs = _chip_smoke()
    cs.SM_CLOCK_HZ = 1.98e9
    got = cs.flash_bound(B, S, H, KH, hd, causal)
    pairs = S * (S + 1) // 2 if causal else S * S
    assert got["scores"] == B * H * pairs
    assert got["bound_by"] == bound_by
    assert got["bound_ms"] == pytest.approx(bound_ms, rel=1e-2)
    terms = got["terms_ms"]
    assert got["bound_ms"] == max(terms["bytes"], terms["tensor_ops"])
    assert terms["ex2_sfu"] == pytest.approx(ex2_ms, rel=1e-2)


def test_chip_smoke_keeps_the_first_design_where_its_entry_has_it():
    """``chip_smoke.kept_first_design``: the head dims at which the Hopper
    design runs and ``flash_attn_mma_launch`` still reaches the mma.sync
    design (its instance 16 at hd 8 and 16; 32, 64, 96 and 256), so the
    limits and flash phases time and hold both in the same call."""
    cs = _chip_smoke()
    kept = [hd for hd in range(1, 257) if cs.kept_first_design(hd)]
    assert kept == [8, 16, 32, 64, 96, 256]
