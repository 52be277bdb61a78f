"""The port's design-space sweep (``repro_torch.sweep``) against the
reference's ``repro.sweep``, on the CPU.

Point for point: the reference's models (warm start from its JAX key) are
carried into the port's runner with ``params_from_numpy``, and
``run_point`` in both packages must agree exactly on every hardware field
and on accuracy, for the ``tiny`` grid and the ``paper`` grid's TEN
points.  With the port's own init (a torch generator), the paper's TEN
points stay within ``TABLE1_TEN_TOLERANCE``.  Then the reference's own
sweep tests, ported: grids, results and their JSON (read across the two
packages), the Pareto rule, the cache, autodesign (also on an MNIST point,
where the reference raises) and the CLI.  Exact comparisons throughout.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process)

import repro.runtime as jruntime  # noqa: E402
import repro.sweep as jsweep  # noqa: E402
from repro.dwn.spec import DWNSpec as JDWNSpec  # noqa: E402
from repro.sweep import artifacts as jart  # noqa: E402
from repro.sweep import cache as jcache  # noqa: E402
from repro.sweep import grid as jgrid  # noqa: E402

import repro_torch.runtime as truntime  # noqa: E402
import repro_torch.sweep as tsweep  # noqa: E402
from repro_torch.core.model import params_from_numpy  # noqa: E402
from repro_torch.dwn.spec import DWNSpec  # noqa: E402
from repro_torch.sweep import (SweepCache, SweepPoint, SweepResult,  # noqa: E402
                               SweepRunner, SweepSettings, pareto_front,
                               point_key, run_grid)
from repro_torch.sweep import artifacts as tart  # noqa: E402
from repro_torch.sweep import cache as tcache  # noqa: E402
from repro_torch.sweep import grid as tgrid  # noqa: E402
from repro_torch.sweep.artifacts import (PRESETS,  # noqa: E402
                                         TABLE1_TEN_TOLERANCE,
                                         paper_reference)
from repro_torch.sweep.grid import load_grid, paper_grid, tiny_grid  # noqa: E402
from repro_torch.sweep.results import EXACT_FIELDS  # noqa: E402


ROOT = Path(__file__).resolve().parents[1]

FAST = SweepSettings(n_train=512, n_test=256, accuracy=True,
                     kernel=False, serve=False, device="cpu")
JFAST = jsweep.SweepSettings(n_train=512, n_test=256, accuracy=True,
                             kernel=False, serve=False)

#: every hardware field and accuracy: equal, point for point
FIELDS = EXACT_FIELDS

#: the tiny grid and the paper grid's TEN points not already in it
PARITY_POINTS = tiny_grid() + [p for p in paper_grid()
                               if p.variant == "TEN" and p not in tiny_grid()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the suite runs timing-bound
    reference tests in parallel workers beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpoint(p: SweepPoint):
    return jgrid.SweepPoint.from_dict(p.to_dict())


@pytest.fixture(scope="module")
def parity():
    """label -> (reference PointResult, port PointResult): the port's
    runner runs on the reference runner's models, carried across."""
    jr, tr = jsweep.SweepRunner(JFAST), SweepRunner(FAST)
    out = {}
    for p in PARITY_POINTS:
        jres = jr.run_point(_jpoint(p))
        key = (p.workload, p.preset, p.bits, p.placement)
        if key not in tr._models:
            _, params, buffers = jr._models[key]
            params = jax.tree_util.tree_map(np.asarray, params)
            tr._models[key] = (SweepRunner._cfg_for(p), *params_from_numpy(
                params, {"thresholds": np.asarray(buffers["thresholds"])}))
        out[p.label] = (jres, tr.run_point(p))
    return out


@pytest.fixture(scope="module")
def tiny_result():
    return run_grid("tiny", FAST, cache_dir=None)


@pytest.fixture(scope="module")
def paper_ten_result():
    return run_grid([p for p in paper_grid() if p.variant == "TEN"], FAST,
                    cache_dir=None)


# ---------------------------------------------------------------------------
# point for point against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", [p.label for p in PARITY_POINTS])
def test_run_point_equals_reference(parity, label):
    """Exact: with the reference's model carried in, every hardware field
    and the packed hard accuracy equal the reference's."""
    jres, tres = parity[label]
    for f in FIELDS:
        assert getattr(tres, f) == getattr(jres, f), (label, f)
    assert tres.point.to_dict() == jres.point.to_dict()
    assert tres.accuracy is not None and tres.total_luts > 0


@pytest.mark.parametrize("label", [p.label for p in PARITY_POINTS])
def test_point_key_payload_and_spec_fingerprint_equal_reference(
        monkeypatch, label):
    """Exact: ``point_key`` hashes the reference's point and spec payload;
    its settings differ by the port's ``device`` alone, and the code
    fingerprint hashes the port's own modules."""
    p = next(q for q in PARITY_POINTS if q.label == label)
    payloads = {}
    for name, mod, pt, st in (("port", tcache, p, FAST),
                              ("ref", jcache, _jpoint(p), JFAST)):
        monkeypatch.setattr(mod, "config_hash",
                            lambda d, name=name: payloads.setdefault(name, d)
                            and "k")
        mod.point_key(pt, st)
    port, ref = payloads["port"], payloads["ref"]
    assert port["point"] == ref["point"]
    assert port["spec"] == ref["spec"]
    assert port["settings"] == {**ref["settings"], "device": "cpu"}
    assert port["code"] != ref["code"]
    for datapath in ("fused-packed", "packed-xla", "auto"):
        assert (DWNSpec.from_point(p, datapath=datapath).fingerprint()
                == JDWNSpec.from_point(_jpoint(p),
                                       datapath=datapath).fingerprint())


# ---------------------------------------------------------------------------
# paper-constant calibration through the port's own init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_table1_ten_rows_within_documented_tolerance(paper_ten_result,
                                                     preset):
    """Table I TEN LUT counts reproduce through the port's pipeline, from
    its torch-generator warm start, within the reference's tolerances."""
    r = next(r for r in paper_ten_result.points if r.point.preset == preset)
    assert r.paper_luts is not None, r.point
    tol = TABLE1_TEN_TOLERANCE[preset]
    err = abs(r.total_luts - r.paper_luts) / r.paper_luts
    assert err <= tol, (preset, r.total_luts, r.paper_luts, err)
    # TEN: no on-chip encoder, and the breakdown sums to the total
    assert r.luts["encoder"] == 0
    assert sum(r.luts.values()) == r.total_luts


def test_paper_reference_resolution():
    assert paper_reference(SweepPoint("sm-50", "TEN")) == 110
    assert paper_reference(SweepPoint("sm-50", "PEN", input_bits=8)) == 311
    assert paper_reference(SweepPoint("sm-50", "PEN", input_bits=9)) == 345
    # off the published operating point -> no reference
    assert paper_reference(SweepPoint("sm-50", "TEN", bits=100)) is None
    assert paper_reference(
        SweepPoint("sm-50", "TEN", placement="uniform")) is None


@pytest.mark.parametrize("name", sorted(tgrid.GRIDS))
def test_grids_and_paper_references_equal_reference(name):
    """Exact: every named grid lists the reference's points, labels and
    paper references, in order."""
    tp, jp = tgrid.GRIDS[name](), jgrid.GRIDS[name]()
    assert [p.to_dict() for p in tp] == [p.to_dict() for p in jp]
    assert [p.label for p in tp] == [p.label for p in jp]
    assert [p.frac_bits for p in tp] == [p.frac_bits for p in jp]
    assert ([tart.paper_reference(p) for p in tp]
            == [jart.paper_reference(p) for p in jp])


def test_constants_and_exports_equal_reference():
    """The copied constants are the reference's, unchanged, and the
    ``sweep`` and ``runtime`` packages export the reference's names."""
    assert tart.TABLE1_TEN_TOLERANCE == jart.TABLE1_TEN_TOLERANCE
    assert tart.PRESETS == jart.PRESETS
    assert tgrid.PAPER_FT_BITS == jgrid.PAPER_FT_BITS
    assert tgrid.VARIANTS == jgrid.VARIANTS
    assert sorted(tgrid.GRIDS) == sorted(jgrid.GRIDS)
    assert tart.literature_points() == jart.literature_points()
    for n, ref in ((5, 10), (None, 10), (12, None)):
        assert tart.lut_error_pct(n or 0, ref) == jart.lut_error_pct(n or 0,
                                                                     ref)
    assert set(tsweep.__all__) == set(jsweep.__all__)
    for mod in (tsweep, truntime):
        assert all(hasattr(mod, n) for n in mod.__all__)

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")}
    assert public(truntime) == public(jruntime)
    assert set(truntime.__all__) == public(jruntime)
    # SweepSettings: the reference's fields, in order, then the device
    names = [f.name for f in dataclasses.fields(SweepSettings)]
    assert names == [f.name for f in dataclasses.fields(
        jsweep.SweepSettings)] + ["device"]
    assert SweepSettings().device == "cuda"


def test_artifact_rows_equal_reference():
    """Exact: Table I rows, the Fig. 5 breakdown, our Fig. 6 points and
    Fig. 2's per-feature popcounts from the same frozen models."""
    from repro.core.model import freeze as jfreeze
    from repro.data.jsc import load_jsc as jload
    from repro_torch.core.model import freeze as tfreeze
    from repro_torch.data.jsc import load_jsc as tload
    jr = jsweep.SweepRunner(JFAST)
    jpt = _jpoint(SweepPoint("sm-50", "TEN"))
    cfg, params, buffers = jr.model_for(jpt)
    tcfg = SweepRunner._cfg_for(SweepPoint("sm-50", "TEN"))
    tparams, tbuffers = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        {"thresholds": np.asarray(buffers["thresholds"])})
    jb = {"frozen_ten": jfreeze(params, buffers, cfg),
          "frozen_ft": jfreeze(params, buffers, cfg, input_frac_bits=7),
          "ft_bits": 8, "float_acc": 0.7, "ft_acc": 0.69}
    tb = {"frozen_ten": tfreeze(tparams, tbuffers, tcfg),
          "frozen_ft": tfreeze(tparams, tbuffers, tcfg, input_frac_bits=7),
          "ft_bits": 8, "float_acc": 0.7, "ft_acc": 0.69}
    trows = tart.table1_model_rows(tb, "sm-50")
    jrows = jart.table1_model_rows(jb, "sm-50")
    for (tv, trep, tpaper, terr), (jv, jrep, jpaper, jerr) in zip(trows,
                                                                  jrows):
        assert (tv, tpaper, terr) == (jv, jpaper, jerr)
        assert trep.luts == jrep.luts and trep.total_ffs == jrep.total_ffs
    assert ([(b, l, t) for b, l, t in tart.breakdown_rows(tb["frozen_ft"],
                                                          "sm-50")]
            == [(b, l, t) for b, l, t in jart.breakdown_rows(
                jb["frozen_ft"], "sm-50")])
    assert tart.our_points(tb, "sm-50") == jart.our_points(jb, "sm-50")
    tpop = tart.placement_popcounts(tload(512, 64))
    jpop = jart.placement_popcounts(jload(512, 64))
    assert sorted(tpop) == sorted(jpop)
    for mode in tpop:
        np.testing.assert_array_equal(tpop[mode], jpop[mode])


def test_encoding_mode_accuracy_from_a_torch_generator():
    """The Fig. 2 recipe in the port: a torch-generator warm start, one
    epoch on the CPU; an accuracy in [0, 1], the same on a second run."""
    from repro_torch.data.jsc import load_jsc
    data = load_jsc(512, 256)
    accs = [tart.encoding_mode_accuracy(data, "sm-10", "uniform", epochs=1,
                                        device="cpu") for _ in range(2)]
    assert 0.0 <= accs[0] <= 1.0 and accs[0] == accs[1]


# ---------------------------------------------------------------------------
# tiny end-to-end grid
# ---------------------------------------------------------------------------

def test_tiny_grid_encoder_luts_monotone_in_bits(tiny_result):
    """2 presets x 2 PEN bit-widths: encoder LUTs grow with input width."""
    by = {r.point.label: r for r in tiny_result.points}
    for preset in ("sm-10", "sm-50"):
        pen4 = by[f"{preset}/PEN@4b/T200/distributive"]
        pen9 = by[f"{preset}/PEN@9b/T200/distributive"]
        assert 0 < pen4.luts["encoder"] < pen9.luts["encoder"]
        ten = by[f"{preset}/TEN/T200/distributive"]
        assert ten.luts["encoder"] == 0
        assert ten.total_luts < pen4.total_luts < pen9.total_luts


def test_tiny_grid_axes_populated(tiny_result):
    for r in tiny_result.points:
        assert 0.0 <= r.accuracy <= 1.0
        assert r.total_luts > 0 and r.total_ffs > 0
        assert r.delay_ns > 0 and r.fmax_mhz > 0
        assert set(r.luts) == {"encoder", "lut_layer", "popcount", "argmax"}
        assert r.kernel_us is None and r.serve_throughput is None
    assert tiny_result.settings["device"] == "cpu"
    assert tiny_result.executor["mode"] == "serial"


def test_sweep_result_json_roundtrip(tmp_path, tiny_result):
    f = tmp_path / "sweep.json"
    tiny_result.save(f)
    loaded = SweepResult.load(f)
    assert [r.point for r in loaded.points] == \
        [r.point for r in tiny_result.points]
    assert [r.total_luts for r in loaded.points] == \
        [r.total_luts for r in tiny_result.points]
    assert loaded.settings == tiny_result.settings


def test_sweep_json_reads_across_packages(tmp_path, parity):
    """A sweep JSON the reference saved loads in the port, and the
    reverse, with every row's fields as written."""
    labels = [p.label for p in PARITY_POINTS]
    jres = jsweep.SweepResult(grid="tiny",
                              settings=dataclasses.asdict(JFAST),
                              points=[parity[l][0] for l in labels])
    tres = SweepResult(grid="tiny", settings=dataclasses.asdict(FAST),
                       points=[parity[l][1] for l in labels],
                       executor={"mode": "serial"})
    jres.save(tmp_path / "ref.json")
    tres.save(tmp_path / "port.json")
    in_port = SweepResult.load(tmp_path / "ref.json")
    in_ref = jsweep.SweepResult.load(tmp_path / "port.json")
    assert [r.to_dict() for r in in_port.points] == \
        [r.to_dict() for r in jres.points]
    assert [r.to_dict() for r in in_ref.points] == \
        [r.to_dict() for r in tres.points]
    assert in_ref.executor == {"mode": "serial"}
    assert in_port.to_dict()["pareto"] == jres.to_dict()["pareto"]
    assert in_port.table() == jres.table()


def test_pareto_front_rule():
    pts = [("a", 70.0, 10), ("b", 75.0, 100), ("c", 72.0, 50),
           ("d", 75.0, 200), ("none", None, 5)]
    front = pareto_front(pts, cost=lambda p: p[2], score=lambda p: p[1])
    assert [p[0] for p in front] == ["a", "c", "b"]


def test_accuracy_vs_luts_front_is_monotone(tiny_result):
    front = tiny_result.accuracy_vs_luts_front()
    assert front, "tiny grid must yield a non-empty frontier"
    luts = [r.total_luts for r in front]
    accs = [r.accuracy for r in front]
    assert luts == sorted(luts)
    assert accs == sorted(accs)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def test_cache_incremental_rerun(tmp_path):
    pts = [SweepPoint("sm-10", "TEN")]
    first = run_grid(pts, FAST, cache_dir=tmp_path)
    assert not first.points[0].cached
    second = run_grid(pts, FAST, cache_dir=tmp_path)
    assert second.points[0].cached
    assert second.points[0].total_luts == first.points[0].total_luts
    assert second.points[0].accuracy == first.points[0].accuracy
    assert second.executor["computed"] == 0
    # different settings -> different key -> recompute; the device counts
    other = dataclasses.replace(FAST, n_train=513, accuracy=False)
    assert point_key(pts[0], FAST) != point_key(pts[0], other)
    assert point_key(pts[0], FAST) != point_key(
        pts[0], dataclasses.replace(FAST, device="cuda"))


def test_cache_corrupt_entry_is_a_miss(tmp_path):
    """A corrupt cache file reads as a miss — unlinked and recomputed,
    never an exception."""
    cache = SweepCache(tmp_path)
    cache.put("k1", {"x": 1})
    assert cache.get("k1") == {"x": 1}
    (tmp_path / "k2.json").write_text('{"x": ')
    assert cache.get("k2") is None
    assert not (tmp_path / "k2.json").exists()     # unlinked, can't shadow
    (tmp_path / "k3.json").write_text('[1, 2]')
    assert cache.get("k3") is None
    assert cache.get("nope") is None               # plain miss
    assert cache.stats == {"hits": 1, "misses": 3, "corrupt": 2}


def test_cache_put_is_atomic(tmp_path):
    """put publishes via unique-temp + os.replace: no *.tmp survives a
    completed put, and a same-key overwrite is last-writer-wins."""
    cache = SweepCache(tmp_path)
    cache.put("k", {"v": 1})
    cache.put("k", {"v": 2})
    assert cache.get("k") == {"v": 2}
    assert list(tmp_path.glob("*.tmp")) == []
    assert list(tmp_path.glob(".*.tmp")) == []
    # an orphan temp older than an hour is swept by the next put
    orphan = tmp_path / ".k.1.deadbeef.tmp"
    orphan.write_text("{")
    os.utime(orphan, (0, 0))
    cache.put("k", {"v": 3})
    assert not orphan.exists()
    off = SweepCache(None)
    off.put("k", {"v": 3})
    assert off.get("k") is None


def test_cache_corrupt_entry_recomputes_in_pipeline(tmp_path):
    """End to end: corrupting the cached entry forces a recompute that
    repairs the cache (same numbers afterwards)."""
    pts = [SweepPoint("sm-10", "TEN")]
    first = run_grid(pts, FAST, cache_dir=tmp_path)
    key = point_key(pts[0], FAST)
    (tmp_path / f"{key}.json").write_text("garbage{{{")
    second = run_grid(pts, FAST, cache_dir=tmp_path)
    assert not second.points[0].cached             # recomputed, no crash
    assert second.points[0].total_luts == first.points[0].total_luts
    third = run_grid(pts, FAST, cache_dir=tmp_path)
    assert third.points[0].cached                  # cache repaired


def test_grid_resolution(tmp_path):
    assert len(tiny_grid()) == 6
    assert len(paper_grid()) == 8
    with pytest.raises(ValueError):
        load_grid("no-such-grid")
    f = tmp_path / "grid.json"
    f.write_text('[{"preset": "sm-10", "variant": "PEN", "input_bits": 5}]')
    pts = load_grid(str(f))
    assert pts == [SweepPoint("sm-10", "PEN", input_bits=5)]
    assert pts[0].to_dict() == jgrid.load_grid(str(f))[0].to_dict()


def test_runner_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """The runner and the CLI raise without a card when the device is
    the default ``cuda``; they never fall back to the CPU."""
    from repro_torch.launch import sweep as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepRunner(SweepSettings())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_grid("tiny", SweepSettings(), cache_dir=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--grid", "tiny", "--cache-dir", ""])


def test_kernel_and_serve_axes_on_the_cpu():
    """The kernel axis (K2's wrapper, its plain version on CPU tensors)
    and the serve axis (the engine, startup oracle check on) fill their
    fields on the CPU; the hardware fields do not move."""
    s = dataclasses.replace(FAST, kernel=True, serve=True, kernel_iters=1,
                            serve_batch=16, kernel_batch=300)
    pt = SweepPoint("sm-10", "PEN", input_bits=6)
    r = SweepRunner(s).run_point(pt)
    base = SweepRunner(FAST).run_point(pt)
    assert r.kernel_us > 0 and r.kernel_batch == 300
    assert r.serve_throughput > 0 and r.serve_p50_ms > 0
    assert r.serve_backend == "fused-packed"
    for f in FIELDS:
        assert getattr(r, f) == getattr(base, f), f


# ---------------------------------------------------------------------------
# autodesign: Pareto choice + verified emission
# ---------------------------------------------------------------------------

def _fake_result(rows, point=lambda i: SweepPoint("sm-10", "TEN",
                                                  bits=8 * (i + 1))):
    from repro_torch.sweep.results import PointResult
    pts = [PointResult(point=point(i), accuracy=acc, total_luts=luts)
           for i, (acc, luts) in enumerate(rows)]
    return SweepResult(grid="fake", settings={}, points=pts)


def test_choose_design_min_luts_at_floor():
    from repro_torch.sweep.autodesign import AutodesignError, choose_design
    res = _fake_result([(0.60, 100), (0.70, 200), (0.75, 400),
                        (0.50, 150), (0.74, 390)])
    c = choose_design(res, acc_floor=0.65)
    assert c.result.total_luts == 200          # cheapest point >= floor
    assert c.objective.startswith("min-luts")
    with pytest.raises(AutodesignError, match="best on"):
        choose_design(res, acc_floor=0.90)


def test_choose_design_max_acc_under_budget():
    from repro_torch.sweep.autodesign import AutodesignError, choose_design
    res = _fake_result([(0.60, 100), (0.70, 200), (0.75, 400)])
    c = choose_design(res, lut_budget=250)
    assert c.result.accuracy == 0.70           # best affordable
    assert choose_design(res, lut_budget=5000).result.accuracy == 0.75
    with pytest.raises(AutodesignError, match="budget"):
        choose_design(res, lut_budget=50)


def test_choose_design_needs_exactly_one_objective():
    from repro_torch.sweep.autodesign import AutodesignError, choose_design
    res = _fake_result([(0.6, 100)])
    with pytest.raises(AutodesignError, match="exactly one"):
        choose_design(res)
    with pytest.raises(AutodesignError, match="exactly one"):
        choose_design(res, acc_floor=0.5, lut_budget=100)
    res_noacc = _fake_result([(None, 100)])
    with pytest.raises(AutodesignError, match="accuracy"):
        choose_design(res_noacc, acc_floor=0.5)


def test_autodesign_emits_verified_rtl(tmp_path, tiny_result):
    """End to end on the tiny sweep: choose, rebuild, co-simulate, write
    RTL + summary."""
    from repro_torch.hw.verilog import well_formed
    from repro_torch.sweep.autodesign import choose_design, emit_verified
    choice = choose_design(tiny_result, acc_floor=0.30)
    summary = emit_verified(choice, FAST, out_dir=tmp_path,
                            n_vectors=64, backend="python", log=None)
    rtl = (tmp_path / "dwn_autodesign.v").read_text()
    assert well_formed(rtl) and "module dwn_autodesign" in rtl
    on_disk = json.loads((tmp_path / "autodesign.json").read_text())
    assert on_disk["verification"]["n_vectors"] == 64
    assert on_disk["verification"]["counts_checked"]
    assert on_disk["choice"]["chosen"]["point"] == choice.point.to_dict()
    assert summary["spec_label"] == on_disk["spec_label"]


def test_autodesign_verifies_an_mnist_point_on_mnist_vectors(tmp_path):
    """The port co-simulates the chosen point on its own workload's
    vectors; the reference reads JSC's for every point, so the same MNIST
    point raises there in broadcasting (ROADMAP Queue 3, fault 8)."""
    from repro.sweep.autodesign import choose_design as jchoose
    from repro.sweep.autodesign import emit_verified as jemit
    from repro_torch.sweep.autodesign import choose_design, emit_verified
    pt = SweepPoint("mnist-sm", "TEN", bits=8, workload="mnist")
    choice = choose_design(_fake_result([(0.9, 500)], point=lambda i: pt),
                           acc_floor=0.5)
    summary = emit_verified(choice, FAST, out_dir=tmp_path, n_vectors=32,
                            backend="python", log=None)
    assert summary["verification"]["n_vectors"] == 32
    assert summary["verification"]["counts_checked"]
    assert summary["spec"]["workload"] == "mnist"
    assert (tmp_path / "dwn_autodesign.v").exists()
    jres = jsweep.SweepResult(grid="fake", settings={}, points=[
        jsweep.PointResult(point=_jpoint(pt), accuracy=0.9,
                           total_luts=500)])
    with pytest.raises(ValueError, match="broadcast"):
        jemit(jchoose(jres, acc_floor=0.5), JFAST,
              out_dir=tmp_path / "ref", n_vectors=32, backend="python",
              log=None)


def test_autodesign_cli_flags(tmp_path, capsys):
    """--autodesign through the sweep CLI: one command, verified RTL out,
    non-zero exit when the floor is unreachable."""
    from repro_torch.launch.sweep import main
    out = tmp_path / "ad"
    rc = main(["--grid", "tiny", "--no-kernel", "--no-serve",
               "--n-train", "512", "--n-test", "256", "--cache-dir", "",
               "--device", "cpu",
               "--autodesign", "--acc-floor", "0.30", "--cosim-n", "32",
               "--autodesign-out", str(out)])
    assert rc == 0
    assert (out / "dwn_autodesign.v").exists()
    assert "RTL verified bit-exact" in capsys.readouterr().out

    rc_fail = main(["--grid", "tiny", "--no-kernel", "--no-serve",
                    "--n-train", "512", "--n-test", "256",
                    "--cache-dir", "", "--device", "cpu",
                    "--autodesign", "--acc-floor", "0.99",
                    "--autodesign-out", str(tmp_path / "ad2")])
    assert rc_fail == 1
    assert not (tmp_path / "ad2" / "dwn_autodesign.v").exists()


# ---------------------------------------------------------------------------
# the CLI in its own process
# ---------------------------------------------------------------------------

CLI = [sys.executable, "-m", "repro_torch.launch.sweep", "--grid", "tiny",
       "--device", "cpu", "--n-train", "300", "--n-test", "100",
       "--no-kernel", "--no-serve"]


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([*CLI, *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The tiny grid through the CLI: a first run, the same again (all
    cache hits) and a run with two workers into a fresh cache."""
    d = tmp_path_factory.mktemp("cli")
    runs = {}
    for name, argv in (
            ("first", ["--cache-dir", str(d / "c"), "--out",
                       str(d / "first.json")]),
            ("again", ["--cache-dir", str(d / "c"), "--out",
                       str(d / "again.json")]),
            ("workers", ["--cache-dir", str(d / "cw"), "--workers", "2",
                         "--out", str(d / "workers.json")])):
        out = _cli(*argv)
        runs[name] = (out, json.loads((d / f"{name}.json").read_text())
                      if out.returncode == 0 else None)
    return runs


def test_cli_prints_table_front_and_reference_check(cli_runs):
    out, res = cli_runs["first"]
    assert out.returncode == 0, out.stderr[-2000:]
    assert "| point | acc | LUT total |" in out.stdout
    assert "Pareto front (accuracy vs LUTs):" in out.stdout
    assert "Paper reference check:" in out.stdout
    assert "Table I TEN sm-50" in out.stdout
    assert res["executor"]["computed"] == 6 and res["settings"]["device"] \
        == "cpu"


def test_cli_rerun_is_all_cache_hits(cli_runs):
    out, res = cli_runs["again"]
    assert out.returncode == 0, out.stderr[-2000:]
    assert res["executor"]["computed"] == 0
    assert res["executor"]["cache_hits"] == 6
    assert all(p["cached"] for p in res["points"])
    assert "(6 from cache)" in out.stdout


def test_cli_two_workers_equal_serial(cli_runs):
    (out, res), (_, first) = cli_runs["workers"], cli_runs["first"]
    assert out.returncode == 0, out.stderr[-2000:]
    assert res["executor"]["mode"] == "parallel"
    assert res["executor"]["computed"] == 6 and res["executor"]["failed"] \
        == []
    for a, b in zip(res["points"], first["points"]):
        assert {f: a[f] for f in FIELDS + ("point",)} == \
            {f: b[f] for f in FIELDS + ("point",)}
