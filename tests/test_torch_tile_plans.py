"""Host-side layout of the tile kernels K6 (``fused_dwn``) and K4
(``lut_eval_packed``): the slice plans, the choice between the tile
kernels and the rows kernels kept for shapes a tile does not fit,
the widths each wrapper accepts, the rounding of ``block_b`` and
``block_m``, the combine kernel's plain version and the build hash of the
device code the two kernel libraries share.

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
from repro_torch.kernels.autotune import FusedConfig  # noqa: E402
from repro_torch.kernels.fused import kernel as K  # noqa: E402
from repro_torch.kernels.fused import ref as R  # noqa: E402
from repro_torch.kernels.lut_eval import kernel as KL  # noqa: E402

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
    takes as many as fit.  A ``block_m`` whose LUTs alone exceed a block
    is refused, as the rows kernel alone refused it."""
    plan = K.plan_fused_dwn(1000, 16, 2400, 6, 5, block_b, block_m, SMS)
    assert (plan.path, plan.tile_rows, plan.block_m) == \
        ("tiles", rows, luts)
    with pytest.raises(ValueError, match="shared memory"):
        K.plan_fused_dwn(1000, 16, 2400, 6, 5, block_b, 2400, SMS)


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
    """Over widths, fan-ins, tile rows and slice widths, every accepted
    launch takes the tiles path for F <= 454 and the rows kernel above."""
    for F, n, bb, bm in itertools.product(
            (1, 16, 454, 455, 3000), range(1, 9), (1, 32, 4096),
            (1, 128, 480, 700, None)):
        try:
            plan = K.plan_fused_dwn(1000, F, 2400, n, 5, bb, bm, SMS)
        except ValueError:
            assert bm is not None and bm * 4 * (2 ** n + 2 * n) > MAX
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
    widths, fan-ins and tile sizes, the plan raises only where its block
    did not fit either; its refusal of 900 fan-in-8 LUTs a step stays."""
    for F, n, bb, bm, m in itertools.product(
            (1, 16, 300, 454, 455, 5000, 40_000), range(1, 9),
            (1, 16, 32, 256, 4096), (1, 32, 128, 256, 900), (64, 2400)):
        accepted = _pr13_accepts(1000, F, 5, n, bb, bm, m)
        try:
            K.plan_fused_dwn(1000, F, m, n, 5, bb, bm, SMS)
            planned = True
        except ValueError:
            planned = False
        assert planned or not accepted, (F, n, bb, bm, m)
    with pytest.raises(ValueError, match="shared memory"):
        K.plan_fused_dwn(8, 16, 900, 8, 5, K.FUSED_DWN_BLOCK_B, 900, SMS)


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
    """Rows of up to 7264 words (8 warps' rows in a block) at any fan-in:
    the rows kernel's limit, kept; wider rows are refused as before."""
    for W_in, n in itertools.product((1, 100, 454, 455, 3000, 7264),
                                     (1, 6, 10, 16, 20)):
        KL.plan_lut_eval_packed(33, W_in, 256, n, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        KL.plan_lut_eval_packed(33, 7265, 256, 6, SMS)


@pytest.mark.parametrize("B,slices", [(1, 75), (64, 38), (1024, 4),
                                      (4096, 1)])
def test_packed_plan_splits_words_to_fill_the_card(B, slices):
    """Below 132 tiles of 32 the layer's 75 words (lg-2400) are split
    over slices so that tiles x slices fill the card."""
    plan = KL.plan_lut_eval_packed(B, 100, 2400, 6, SMS)
    assert plan.slices == slices
    assert plan.slice_words == -(-75 // slices)


def test_shared_header_edits_rebuild_and_retune(monkeypatch):
    """``kernels/csrc/tiles.cuh`` is device code both tile libraries
    include: an edit to it changes both libraries' build hashes and the
    fused tuner's kernel fingerprint, and no other library's hash; it is
    not a library of its own."""
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
        for name in ("thermometer", "popcount", "flash_attn"):
            assert after[name] == before[name], name
        assert autotune.kernel_fingerprint() != fp
    finally:
        monkeypatch.undo()
        autotune.kernel_fingerprint.cache_clear()
    assert autotune.kernel_fingerprint() == fp
    assert _build.library_path(srcs["fused_dwn"]) == before["fused_dwn"]
