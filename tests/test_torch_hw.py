"""Port vs reference: the hardware model (``hw/cost.py``, ``hw/verilog.py``,
``hw/cosim.py``, ``hw/report.py``), the artifact's hardware stages and the
thermometer helpers they read, on the CPU.

The reference fits one model per spec preset (its ``jax.random`` init);
its parameters cross to the port as numpy and both packages freeze them.
From the same model every comparison is exact: cost reports field by
field, the emitted Verilog byte for byte, the evaluator primitives and
the co-simulation's verdicts.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import thermometer as jth  # noqa: E402
from repro.core.model import DWNConfig as JConfig  # noqa: E402
from repro.core.model import FrozenDWN as JFrozen  # noqa: E402
from repro.dwn import DWNArtifact as JArtifact  # noqa: E402
from repro.dwn import get_spec as jget_spec  # noqa: E402
from repro.dwn import spec_presets as jspec_presets  # noqa: E402
from repro.hw import cosim as jcosim  # noqa: E402
from repro.hw import cost as jcost  # noqa: E402
from repro.hw import report as jreport  # noqa: E402
from repro.hw import verilog as jverilog  # noqa: E402
from repro.sweep.artifacts import TABLE1_TEN_TOLERANCE  # noqa: E402
from repro.workloads import load_workload as jload_workload  # noqa: E402
from repro_torch.core import thermometer as tth  # noqa: E402
from repro_torch.core.model import DWNConfig, FrozenDWN  # noqa: E402
from repro_torch.core.model import params_from_numpy  # noqa: E402
from repro_torch.data.jsc import load_jsc  # noqa: E402
from repro_torch.dwn import (DWNArtifact, DWNSpec, get_spec,  # noqa: E402
                             spec_presets)
from repro_torch.hw import cosim, cost, report, verilog  # noqa: E402
from repro_torch.workloads import load_workload  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "dwn_tiny_pen.v"
#: PEN input widths (total bits) every preset is priced at
PEN_BITS = (6, 8, 9)
#: the 8 JSC spec presets and the 3 MNIST tiers
PRESETS = sorted([n for n in jspec_presets() if n.startswith("dwn-jsc")]
                 + [f"dwn-mnist-{tier}" for tier in ("sm", "md", "lg")])
REPORT_FIELDS = ("variant", "model", "input_bits", "luts", "ffs", "levels",
                 "distinct_comparators", "total_luts", "total_ffs",
                 "delay_ns", "fmax_mhz", "area_delay")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a torch pool over every core in each of them slows all
    of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_FITS: dict = {}


def _numpy_model(spec):
    """The reference's fit of ``spec`` (one per workload, tier, T and
    placement) as numpy params and buffers."""
    key = (spec.workload, spec.preset, spec.bits, spec.placement)
    if key not in _FITS:
        data = jload_workload(spec.workload, 256, 64, seed=0)
        ten = dataclasses.replace(spec, variant="TEN", input_bits=None)
        art = JArtifact(ten).fit(data.x_train, seed=0)
        _FITS[key] = (jax.tree_util.tree_map(np.asarray, art.params),
                      {"thresholds": np.asarray(art.buffers["thresholds"])})
    return _FITS[key]


def _both(name, variant="TEN", input_bits=None):
    """(reference artifact, port artifact), both frozen from one numpy
    model of the preset ``name`` at ``variant``."""
    jspec = dataclasses.replace(jget_spec(name), variant=variant,
                                input_bits=input_bits)
    spec = dataclasses.replace(get_spec(name), variant=variant,
                               input_bits=input_bits)
    params, buffers = _numpy_model(jspec)
    jart = JArtifact(jspec).adopt(params, buffers).freeze()
    art = DWNArtifact(spec).adopt(
        *params_from_numpy(params, buffers)).freeze()
    return jart, art


def _report_fields(rep):
    return {f: getattr(rep, f) for f in REPORT_FIELDS}


def _as_tensors(frozen):
    """``frozen`` with its arrays as CPU tensors."""
    return dataclasses.replace(
        frozen, thresholds=torch.from_numpy(frozen.thresholds),
        mapping_idx=[torch.from_numpy(i) for i in frozen.mapping_idx],
        tables_bin=[torch.from_numpy(t) for t in frozen.tables_bin])


def test_presets_cover_the_eight_jsc_presets_and_three_mnist_tiers():
    assert len(PRESETS) == 11
    assert sum(n.startswith("dwn-mnist") for n in PRESETS) == 3
    assert set(PRESETS) <= set(spec_presets())


@pytest.mark.parametrize("name", PRESETS)
def test_hw_report_and_verilog_equal_the_reference(name):
    """Exact: from one numpy model, TEN and PEN at 6, 8 and 9 input bits,
    every field of the cost report (through the artifact and through
    ``dwn_hw_report`` on the bare frozen model, numpy or tensors) and the
    emitted Verilog, pipelined and not, byte for byte."""
    for variant, bits in [("TEN", None)] + [("PEN", b) for b in PEN_BITS]:
        jart, art = _both(name, variant, bits)
        np.testing.assert_array_equal(art.frozen.thresholds,
                                      jart.frozen.thresholds)
        want = _report_fields(jart.hw_report())
        assert _report_fields(art.hw_report()) == want, (name, bits)
        frozen_t = _as_tensors(art.frozen)
        for frozen in (art.frozen, frozen_t):
            rep = cost.dwn_hw_report(frozen, variant=variant,
                                     name=art.spec.preset, input_bits=bits)
            assert _report_fields(rep) == want
        for pipeline in (True, False):
            src = art.verilog(name="dwn_t", pipeline=pipeline)
            assert src == jart.verilog(name="dwn_t", pipeline=pipeline)
            assert verilog.emit_dwn(frozen_t, name="dwn_t",
                                    pipeline=pipeline) == src
        assert verilog.well_formed(src)


def test_pen_prices_the_encoder_and_ten_does_not():
    """The paper's claim in the port: at lg-2400 the on-chip encoder
    multiplies the LUT count; TEN has no encoder LUTs."""
    _, ten = _both("dwn-jsc-lg")
    _, pen = _both("dwn-jsc-lg", "PEN", 9)
    r_ten, r_pen = ten.hw_report(), pen.hw_report()
    assert r_ten.luts["encoder"] == 0 and r_pen.luts["encoder"] > 0
    assert r_pen.total_luts > 2 * r_ten.total_luts
    assert r_pen.distinct_comparators <= int(
        tth.used_threshold_mask(pen.frozen.mapping_idx[0],
                                pen.frozen.cfg.thermometer).sum())


@pytest.mark.parametrize("width", [1, 5, 6, 7, 12, 13, 17])
def test_component_costs_equal_the_reference(width):
    """Exact: the component rules at several widths and group sizes."""
    assert cost.comparator_luts(width) == jcost.comparator_luts(width)
    assert cost.comparator_levels(width) == jcost.comparator_levels(width)
    assert cost.two_input_comparator_luts(width) == \
        jcost.two_input_comparator_luts(width)
    assert cost.mux2_luts(width) == jcost.mux2_luts(width)
    for n in (width, width * 10, width * 97):
        assert dataclasses.asdict(cost.popcount_tree(n)) == \
            dataclasses.asdict(jcost.popcount_tree(n))
        assert dataclasses.asdict(cost.popcount_cost(n, 5)) == \
            dataclasses.asdict(jcost.popcount_cost(n, 5))
    for c in (2, 5, 10):
        assert dataclasses.asdict(cost.argmax_cost(c, width)) == \
            dataclasses.asdict(jcost.argmax_cost(c, width))
    assert dataclasses.asdict(cost.encoder_cost([width, 3], 9, 40)) == \
        dataclasses.asdict(jcost.encoder_cost([width, 3], 9, 40))


@pytest.mark.parametrize("frac", [None, 3, 5, 8])
def test_threshold_helpers_equal_the_reference(frac):
    """Exact: ``used_threshold_mask`` and ``distinct_used_thresholds`` on
    numpy and on tensors, with wires out of range ignored."""
    rng = np.random.default_rng(3)
    spec = tth.ThermometerSpec(7, 12)
    mapping = rng.integers(-3, 7 * 12 + 3, (40, 6)).astype(np.int32)
    th = np.sort(rng.uniform(-1, 1, (7, 12)).astype(np.float32), axis=1)
    want_mask = jth.used_threshold_mask(mapping, jth.ThermometerSpec(7, 12))
    want = jth.distinct_used_thresholds(th, want_mask, frac_bits=frac)
    for m, t in ((mapping, th),
                 (torch.from_numpy(mapping), torch.from_numpy(th))):
        mask = tth.used_threshold_mask(m, spec)
        assert isinstance(mask, np.ndarray)
        np.testing.assert_array_equal(mask, want_mask)
        assert tth.distinct_used_thresholds(t, mask, frac_bits=frac) == want
        assert tth.distinct_used_thresholds(
            t, torch.from_numpy(mask), frac_bits=frac) == want


def _golden_frozen(pkg_config, pkg_frozen):
    """The reference test's tiny deterministic PEN model (negative
    thresholds, a duplicate, -1.0, an off-grid value)."""
    cfg = pkg_config(num_features=2, bits_per_feature=3, lut_counts=(10,),
                     fan_in=6, num_classes=5)
    th = np.array([[-0.75, -0.75, 0.5],
                   [-1.0, 0.0, 0.4375]], np.float32)
    mapping = (np.arange(60).reshape(10, 6) % 6).astype(np.int32)
    tables = np.array([[(a * (j + 3) // 5 + j) % 2 for a in range(64)]
                       for j in range(10)], np.int32)
    return pkg_frozen(cfg, th, [mapping], [tables], input_frac_bits=4)


def test_emit_dwn_reproduces_the_golden_file():
    """Exact: the reference's pinned source, from the port's emitter."""
    frozen = _golden_frozen(DWNConfig, FrozenDWN)
    src = verilog.emit_dwn(frozen, name="dwn_golden")
    assert src == GOLDEN.read_text()
    assert src == jverilog.emit_dwn(_golden_frozen(JConfig, JFrozen),
                                    name="dwn_golden")
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, size=(64, 2)).astype(np.float32)
    rep = cosim.verify_rtl(frozen, x, backend="python", name="dwn_golden")
    assert rep.counts_checked and rep.n_vectors == 64


def _port_sources():
    """Every spec preset the port registers x {TEN, PEN} x placement,
    fit by the port (one fit per workload, tier, T and placement)."""
    from repro_torch.core.thermometer import PLACEMENTS
    fits: dict = {}
    for name in spec_presets():
        base = get_spec(name)
        for variant in ("TEN", "PEN"):
            for placement in PLACEMENTS:
                spec = dataclasses.replace(
                    base, variant=variant, placement=placement,
                    input_bits=None if variant == "TEN" else 8)
                key = (spec.workload, spec.preset, spec.bits, placement)
                if key not in fits:
                    data = load_workload(spec.workload, 256, 16, seed=0,
                                         device="cpu")
                    ten = dataclasses.replace(spec, variant="TEN",
                                              input_bits=None)
                    a = DWNArtifact(ten).fit(data.x_train, seed=0)
                    fits[key] = (a.params, a.buffers)
                art = DWNArtifact(spec).adopt(*fits[key]).freeze()
                yield name, spec, art.verilog(name="dwn_t")


def test_well_formed_on_every_registered_preset():
    """Every preset the port registers (JSC, MNIST and the LM head) x
    TEN/PEN x the three placements emits well-formed RTL that the netlist
    parser takes whole, as the reference's own test requires of its
    presets."""
    seen = 0
    for name, spec, src in _port_sources():
        assert verilog.well_formed(src), f"{name} {spec.label}"
        net = cosim.parse_netlist(src)
        assert net.pen == (spec.variant == "PEN"), spec.label
        assert net.meta == jcosim.parse_netlist(src).meta
        seen += 1
    assert seen == 15 * 2 * 3
    src = verilog.emit_dwn(_golden_frozen(DWNConfig, FrozenDWN))
    for bad in (src.replace("endmodule", ""),
                src.replace("always @* begin", "always @*"),
                src.replace("(", "", 1), ""):
        assert not verilog.well_formed(bad)
        assert verilog.well_formed(bad) == jverilog.well_formed(bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cosim_primitives_equal_the_reference(seed):
    """Exact: ``eval_*``, ``as_signed``, ``fixed_point_int`` and the
    emitter's fixed-point constants (Python's round half to even) on
    seeded cases."""
    rng = np.random.default_rng(seed)
    for n in (1, 3, 6):
        init = int(rng.integers(0, 2 ** 62)) & ((1 << (1 << n)) - 1)
        sel = rng.integers(0, 2, (33, n))
        np.testing.assert_array_equal(cosim.eval_lut(init, sel),
                                      jcosim.eval_lut(init, sel))
    for width in (2, 6, 9, 12):
        x = rng.integers(-(1 << (width - 1)), 1 << (width - 1), 50)
        c = int(rng.integers(0, 1 << width))
        np.testing.assert_array_equal(
            cosim.eval_comparator(x, c, width),
            jcosim.eval_comparator(x, c, width))
        v = rng.integers(0, 1 << width, 40)
        np.testing.assert_array_equal(cosim.as_signed(v, width),
                                      jcosim.as_signed(v, width))
    bits = rng.integers(0, 2, (20, 37))
    np.testing.assert_array_equal(cosim.eval_popcount(bits),
                                  jcosim.eval_popcount(bits))
    counts = rng.integers(0, 4, (64, 5))          # many ties
    for a, b in zip(cosim.eval_argmax(counts), jcosim.eval_argmax(counts)):
        np.testing.assert_array_equal(a, b)
    x = np.concatenate([rng.uniform(-1.3, 1.3, 200),
                        np.arange(-33, 34) / 32.0 + 1 / 64.0]
                       ).astype(np.float32)
    for frac in (3, 5, 8, 11):
        np.testing.assert_array_equal(cosim.fixed_point_int(x, frac),
                                      jcosim.fixed_point_int(x, frac))
        assert [verilog._fixed_point_const(float(v), frac) for v in x] == \
            [jverilog._fixed_point_const(float(v), frac) for v in x]


@pytest.fixture(scope="module")
def trained():
    """dwn-jsc-sm trained by the port on the CPU (one epoch), frozen."""
    data = load_jsc(1000, 256, seed=0)
    art = DWNArtifact(get_spec("dwn-jsc-sm")).train(
        data, epochs=1, seed=0, device="cpu").freeze()
    return art, data


@pytest.mark.parametrize("variant", ["TEN", "PEN"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_verify_rtl_passes_on_a_port_trained_artifact(trained, variant,
                                                      pipeline):
    """The port's RTL of a model it trained computes the port's packed
    oracle's counts on 256 vectors (Python evaluator), and the
    reference's RTL check passes on the same model and source."""
    art, data = trained
    if variant == "PEN":
        art = DWNArtifact(dataclasses.replace(
            art.spec, variant="PEN", input_bits=9)).adopt(
                art.params, art.buffers).freeze()
    x = data.x_test[:256]
    rep = art.verify_rtl(x, backend="python", pipeline=pipeline)
    assert rep.counts_checked and rep.n_vectors == 256
    assert rep.backends == ["python"] and rep.variant == variant
    assert art.calibration["rtl_verified"] == rep.to_dict()
    jfrozen = JFrozen(JConfig(**dataclasses.asdict(art.frozen.cfg)),
                      art.frozen.thresholds, art.frozen.mapping_idx,
                      art.frozen.tables_bin, art.frozen.input_frac_bits)
    jrep = jcosim.verify_rtl(jfrozen, x, backend="python",
                             pipeline=pipeline)
    assert jrep.src == rep.src


def test_verify_rtl_default_vectors_and_devices(trained):
    """Default vectors come from the spec's workload (a bare 16-feature
    model: JSC; else seeded uniform rows) and the oracle runs where the
    model is: a frozen model of CPU tensors and a packed artifact pass."""
    art = dataclasses.replace(trained[0])
    assert art.verify_rtl(n=32, backend="python").n_vectors == 32
    rep = cosim.verify_rtl(_as_tensors(art.frozen), n=16, backend="python")
    assert rep.n_vectors == 16 and rep.spec is None
    art.pack("cpu")
    assert art.verify_rtl(n=8, backend="python").spec == art.spec.label
    golden = _golden_frozen(DWNConfig, FrozenDWN)         # 2 features
    assert cosim.verify_rtl(golden, n=8, backend="python").n_vectors == 8


def test_mutations_are_detected(trained):
    """A flipped truth table or a threshold with its sign bit flipped
    raises ``RTLMismatch``, in the port as in the reference."""
    art, data = trained
    pen = DWNArtifact(dataclasses.replace(
        art.spec, variant="PEN", input_bits=6)).adopt(
            art.params, art.buffers).freeze()
    src = pen.verilog()
    x = data.x_test[:128]
    m = re.search(r"INIT_0_0 = 64'h([0-9a-f]{16});", src)
    flipped = f"{(~int(m.group(1), 16)) & (2**64 - 1):016x}"
    bad_table = src.replace(f"INIT_0_0 = 64'h{m.group(1)};",
                            f"INIT_0_0 = 64'h{flipped};")
    m = re.search(r"\$signed\(6'h([0-9a-f]+)\)", src)
    orig = int(m.group(1), 16)
    bad_th = src.replace(f"$signed(6'h{m.group(1)})",
                         f"$signed(6'h{(orig ^ 0x20):x})", 1)
    for bad in (bad_table, bad_th):
        with pytest.raises(cosim.RTLMismatch, match="disagrees"):
            cosim.verify_rtl(pen.frozen, x, backend="python", src=bad)
    with pytest.raises(cosim.CosimParseError):
        cosim.parse_netlist(src.replace(
            "endmodule", "  assign foo = bar & baz;\nendmodule"))


def test_iverilog_backend_raises_without_a_simulator(trained, monkeypatch):
    """``backend="iverilog"`` raises ``SimulatorError`` when no simulator
    is on PATH (never a silent pass); ``"auto"`` then runs Python only;
    an unknown backend is refused."""
    art, data = trained
    monkeypatch.setattr(cosim, "simulator_available", lambda: None)
    with pytest.raises(cosim.SimulatorError, match="no Verilog simulator"):
        art.verify_rtl(data.x_test[:4], backend="iverilog")
    assert art.verify_rtl(data.x_test[:4], backend="auto").backends == \
        ["python"]
    with pytest.raises(ValueError, match="unknown cosim backend"):
        art.verify_rtl(data.x_test[:4], backend="vcs")
    tb = cosim.emit_testbench(art.frozen, data.x_test[:3], name="dwn_t")
    assert tb == jcosim.emit_testbench(
        JFrozen(JConfig(**dataclasses.asdict(art.frozen.cfg)),
                art.frozen.thresholds, art.frozen.mapping_idx,
                art.frozen.tables_bin, None), data.x_test[:3], name="dwn_t")


def test_table1_ten_rows_meet_the_reference_tolerances():
    """Table I TEN LUT counts through the port's artifact API land within
    the reference's documented tolerances of the paper's, with no encoder
    LUTs; the port's copies of the paper tables are the reference's."""
    data = load_jsc(1000, 16, seed=0)
    assert report.PAPER_TABLE1 == jreport.PAPER_TABLE1
    assert report.PAPER_TABLE2 == jreport.PAPER_TABLE2
    assert report.PAPER_TABLE3 == jreport.PAPER_TABLE3
    assert report.PAPER_BASELINES == jreport.PAPER_BASELINES
    for preset, tol in TABLE1_TEN_TOLERANCE.items():
        art = DWNArtifact(DWNSpec(preset=preset)).fit(data.x_train).freeze()
        rep = art.hw_report()
        paper = report.PAPER_TABLE3[preset]["ten_luts"]
        assert abs(rep.total_luts - paper) / paper <= tol, \
            (preset, rep.total_luts, paper)
        assert rep.luts["encoder"] == 0
        row = report.compare_with_paper(art.frozen, model_name=preset,
                                        variant="TEN")
        assert row.paper_luts == paper
        assert abs(row.lut_error_pct) <= 100 * tol


def test_cosim_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.hw.cosim`` verifies JSC and MNIST presets,
    TEN and PEN, and exits 0 (its report JSON agrees everywhere); with
    ``--require-simulator`` and no simulator it exits 2."""
    out = tmp_path / "cosim.json"
    assert cosim.main(["--presets", "dwn-jsc-sm,dwn-mnist-sm", "--n", "32",
                       "--n-train", "256", "--backend", "python",
                       "--device", "cpu", "--out", str(out)]) == 0
    import json
    rows = json.loads(out.read_text())["results"]
    assert len(rows) == 4 and all(r["agree"] for r in rows)
    assert capsys.readouterr().out.count("cosim OK") == 4
    monkeypatch.setattr(cosim, "simulator_available", lambda: None)
    assert cosim.main(["--require-simulator", "--n", "4",
                       "--device", "cpu"]) == 2
    assert cosim.main(["--backend", "iverilog", "--n", "4",
                       "--device", "cpu"]) == 2
