"""Co-simulation harness: golden-model verification of emitted RTL.

The port's copy of the reference's ``repro.hw.cosim``.  The Verilog that
``hw.verilog.emit_dwn`` produces is parsed and *executed* against the
packed inference oracle (the port's ``core.model.apply_hard_packed``,
plain tensor ops run on the frozen model's device, its float32 counts
taken to int64 numpy before any comparison), asserting bit-exact
agreement on real vectors of the model's workload — per-class counts,
the winning count, and the tie-to-lower argmax index.

Two backends:

* **python** (always available, zero dependencies) — a structural
  interpreter for the restricted Verilog subset the emitter produces:

      =====================  ===========================================
      construct              semantics evaluated
      =====================  ===========================================
      PEN comparator         ``($signed(x[f]) > $signed(W'hC))`` as a
                             signed two's-complement integer compare
      dup-threshold alias    ``assign enc[i] = enc[j];`` (CSE fan-out)
      TEN input alias        ``wire enc = ten_bits;``
      LUT6 lookup            ``INIT_l_j[{sel5, ..., sel0}]`` — MSB-first
                             concat selects bit ``sum(sel_i << i)`` of
                             the 64-bit truth-table constant
      popcount               ``pc_c = prev[a] + prev[b] + ...`` (the
                             adder chain synthesis maps to a compressor
                             tree; evaluated as an exact integer sum)
      pipeline register      ``always @(posedge clk) q <= d;`` — the
                             datapath is feed-forward, so steady state
                             is ``q == d`` (the simulator backend clocks
                             the pipeline for real)
      argmax                 the strict-``>`` comparator chain; ties
                             keep the lower class index
      =====================  ===========================================

  Any line outside this subset raises :class:`CosimParseError` — the
  evaluator refuses to silently skip constructs it does not model.

* **iverilog** (optional, detected at run time) — emits a
  self-checking testbench (:func:`emit_testbench`), compiles DUT + bench
  with Icarus Verilog, runs ``vvp``, and compares ``$display`` output
  lines (no VCD parsing).  Same comparison, real event-driven
  simulation, real clocked pipeline registers.

Entry points: :func:`verify_rtl` (library; also exposed as the
``DWNArtifact.verify_rtl`` lifecycle method) and
``python -m repro_torch.hw.cosim`` (CLI — the gate over the
``dwn-jsc-{sm,md,lg}`` presets by default, TEN and PEN; any registered
spec preset, e.g. ``dwn-mnist-lg``; ``--device`` is where the oracle
runs, ``cuda`` unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..core.model import apply_hard_packed, frozen_device, host_frozen
from ..core.thermometer import encode_np, quantize_fixed_point
from .verilog import emit_dwn


class CosimError(RuntimeError):
    """Base class for co-simulation failures."""


class CosimParseError(CosimError):
    """The netlist contains a construct outside the supported subset."""


class SimulatorError(CosimError):
    """The external simulator is missing or failed to compile/run."""


class RTLMismatch(CosimError):
    """The emitted RTL disagrees with the packed oracle."""


# ---------------------------------------------------------------------------
# evaluator primitives (property-tested against direct numpy models)
# ---------------------------------------------------------------------------

def as_signed(value, width: int):
    """Reinterpret ``width``-bit patterns as two's-complement integers."""
    v = np.asarray(value, np.int64)
    sign = np.int64(1) << np.int64(width - 1)
    return np.where(v & sign, v - (np.int64(1) << np.int64(width)), v)


def eval_comparator(x, const: int, width: int):
    """The PEN comparator: ``$signed(x) > $signed(width'h const)``.

    ``x`` are already-signed integers on the (1, n) grid; ``const`` is
    the raw two's-complement literal from the netlist.
    """
    thr = int(as_signed(const, width))
    return (np.asarray(x, np.int64) > thr).astype(np.uint8)


def eval_lut(init: int, sel):
    """LUT lookup: bit ``sum(sel[..., i] << i)`` of the ``init`` constant.

    ``sel[..., i]`` is address bit i (LSB); matches the emitted MSB-first
    concat ``INIT[{sel_{n-1}, ..., sel_0}]``.
    """
    sel = np.asarray(sel, np.int64)
    n = sel.shape[-1]
    table = np.array([(init >> a) & 1 for a in range(1 << n)], np.uint8)
    addr = np.zeros(sel.shape[:-1], np.int64)
    for i in range(n):
        addr |= sel[..., i] << i
    return table[addr]


def eval_popcount(bits):
    """Exact integer sum over the last axis of a {0,1} array."""
    return np.asarray(bits, np.int64).sum(axis=-1)


def eval_argmax(counts):
    """(max_count, argmax) with ties resolved to the LOWER class index —
    the strict-``>`` chain the RTL implements, and ``np.argmax``'s
    first-maximum rule."""
    c = np.asarray(counts, np.int64)
    return c.max(axis=-1), c.argmax(axis=-1)


def fixed_point_int(values, frac_bits: int):
    """Float features -> signed integers on the (1, n) grid.

    Mirrors the oracle's ``quantize_fixed_point`` (round in float32,
    clip to [-1, (2^n - 1)/2^n]) then scales to the integer the hardware
    comparator sees.  Exact for ``frac_bits <= 23`` (the grid values are
    float32-representable).
    """
    q = np.asarray(quantize_fixed_point(np.asarray(values, np.float32),
                                        frac_bits))
    return np.round(q.astype(np.float64) * (1 << frac_bits)).astype(np.int64)


# ---------------------------------------------------------------------------
# netlist parser
# ---------------------------------------------------------------------------

_RE_PORT_PEN = re.compile(
    r"^input\s+wire\s+signed\s+\[(\d+):0\]\s+(\w+)\s+\[(\d+)\],?$")
_RE_PORT_TEN = re.compile(r"^input\s+wire\s+\[(\d+):0\]\s+(\w+),?$")
_RE_PORT_OUT = re.compile(r"^output\s+wire\s+\[(\d+):0\]\s+(\w+),?$")
_RE_WIRE = re.compile(r"^wire\s+\[(\d+):0\]\s+(\w+);$")
_RE_WIRE_EQ = re.compile(r"^wire\s+\[(\d+):0\]\s+(\w+)\s*=\s*(.+);$")
_RE_REG = re.compile(r"^reg\s+\[(\d+):0\]\s+(\w+);$")
_RE_FF = re.compile(r"^always\s+@\(posedge clk\)\s+(\w+)\s*<=\s*(\w+);$")
_RE_ASSIGN = re.compile(r"^assign\s+(\w+)(?:\[(\d+)\])?\s*=\s*(.+);$")
_RE_LOCALPARAM = re.compile(
    r"^localparam\s+\[(\d+):0\]\s+(\w+)\s*=\s*\d+'h([0-9a-fA-F]+);$")
_RE_CMP = re.compile(
    r"^\(\$signed\((\w+)\[(\d+)\]\)\s*>\s*\$signed\((\d+)'h([0-9a-fA-F]+)\)\)$")
_RE_BITREF = re.compile(r"^(\w+)\[(\d+)\]$")
_RE_LUTREF = re.compile(r"^(\w+)\[\{(.+)\}\]$")
_RE_AM_INIT = re.compile(r"^best_v\s*=\s*(\w+);\s*best_i\s*=\s*\d+'d0;$")
_RE_AM_IF = re.compile(
    r"^if\s+\((\w+)\s*>\s*best_v\)\s+begin\s+best_v\s*=\s*(\w+);\s*"
    r"best_i\s*=\s*\d+'d(\d+);\s+end$")


@dataclasses.dataclass
class ParsedNetlist:
    """Structural view of one emitted DWN module (python backend IR)."""

    name: str
    pen: bool
    input_name: str
    input_width: int              # per-element width (PEN) / total (TEN)
    num_features: int             # PEN array size; 0 for TEN
    out_count: str                # max_count port name
    out_index: str                # argmax_idx port name
    widths: dict                  # bit-vector signal -> width
    ops: list                     # ordered evaluation plan
    argmax_srcs: list             # per-class count signal names, in order
    meta: dict                    # parsed // header metadata


def _bitrefs(expr: str) -> list[tuple[str, int]]:
    refs = []
    for part in expr.split("+"):
        m = _RE_BITREF.match(part.strip())
        if not m:
            raise CosimParseError(f"unsupported sum term: {part.strip()!r}")
        refs.append((m.group(1), int(m.group(2))))
    return refs


def parse_netlist(src: str) -> ParsedNetlist:
    """Parse one emitted DWN module into an ordered evaluation plan.

    Raises :class:`CosimParseError` on any construct outside the
    supported subset (see module docstring).
    """
    meta: dict = {}
    name = ""
    pen = False
    input_name, input_width, num_features = "", 0, 0
    outs: list[tuple[str, int]] = []
    widths: dict = {}
    ops: list = []
    argmax_srcs: list = []
    in_ports = False
    in_argmax = False

    for raw in src.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("//"):
            for kv in line[2:].split():
                if "=" in kv:
                    k, _, v = kv.partition("=")
                    meta.setdefault(k, v)
            continue
        code = line.split("//", 1)[0].strip()
        if not code:
            continue

        if in_argmax:
            if code == "end":
                in_argmax = False
                continue
            m = _RE_AM_INIT.match(code)
            if m:
                argmax_srcs = [m.group(1)]
                continue
            m = _RE_AM_IF.match(code)
            if m:
                if m.group(1) != m.group(2):
                    raise CosimParseError(f"argmax update reads "
                                          f"{m.group(1)} but assigns "
                                          f"{m.group(2)}")
                c = int(m.group(3))
                if c != len(argmax_srcs):
                    raise CosimParseError(
                        f"argmax class {c} out of order "
                        f"(expected {len(argmax_srcs)})")
                argmax_srcs.append(m.group(1))
                continue
            raise CosimParseError(f"unsupported argmax statement: {code!r}")

        if code.startswith("module "):
            name = code.split()[1]
            in_ports = True
            continue
        if in_ports:
            if code == ");":
                in_ports = False
                continue
            if code == "input  wire clk," or code == "input wire clk,":
                continue
            m = _RE_PORT_PEN.match(code)
            if m:
                pen = True
                input_width = int(m.group(1)) + 1
                input_name = m.group(2)
                num_features = int(m.group(3))
                continue
            m = _RE_PORT_OUT.match(code)
            if m:
                outs.append((m.group(2), int(m.group(1)) + 1))
                continue
            m = _RE_PORT_TEN.match(code)
            if m:
                input_name = m.group(2)
                input_width = int(m.group(1)) + 1
                widths[input_name] = input_width
                continue
            raise CosimParseError(f"unsupported port: {code!r}")
        if code == "endmodule":
            continue

        m = _RE_WIRE.match(code) or _RE_REG.match(code)
        if m:
            widths[m.group(2)] = int(m.group(1)) + 1
            continue
        m = _RE_WIRE_EQ.match(code)
        if m:
            w, dst, rhs = int(m.group(1)) + 1, m.group(2), m.group(3).strip()
            widths[dst] = w
            if re.fullmatch(r"\w+", rhs):
                ops.append(("vec", dst, rhs))        # wire enc = ten_bits;
            else:
                ops.append(("sum", dst, _bitrefs(rhs)))
            continue
        m = _RE_FF.match(code)
        if m:
            ops.append(("vec", m.group(1), m.group(2)))
            continue
        m = _RE_LOCALPARAM.match(code)
        if m:
            widths[m.group(2)] = int(m.group(1)) + 1
            ops.append(("const", m.group(2), int(m.group(3), 16)))
            continue
        m = _RE_ASSIGN.match(code)
        if m:
            dst, bit, rhs = m.group(1), m.group(2), m.group(3).strip()
            if bit is None:                          # assign max_count = ...
                if not re.fullmatch(r"\w+", rhs):
                    raise CosimParseError(f"unsupported assign RHS: {rhs!r}")
                ops.append(("out", dst, rhs))
                continue
            bit = int(bit)
            mc = _RE_CMP.match(rhs)
            if mc:
                ops.append(("cmp", dst, bit, mc.group(1), int(mc.group(2)),
                            int(mc.group(3)), int(mc.group(4), 16)))
                continue
            ml = _RE_LUTREF.match(rhs)
            if ml:
                sels = [s.strip() for s in ml.group(2).split(",")]
                refs = []
                for s in sels:
                    mb = _RE_BITREF.match(s)
                    if not mb:
                        raise CosimParseError(f"unsupported LUT select: "
                                              f"{s!r}")
                    refs.append((mb.group(1), int(mb.group(2))))
                ops.append(("lut", dst, bit, ml.group(1), refs))
                continue
            mb = _RE_BITREF.match(rhs)
            if mb:                                   # dup-threshold alias
                ops.append(("bit", dst, bit, mb.group(1), int(mb.group(2))))
                continue
            raise CosimParseError(f"unsupported assign RHS: {rhs!r}")
        if code == "always @* begin":
            in_argmax = True
            continue
        raise CosimParseError(f"unsupported statement: {code!r}")

    if not name:
        raise CosimParseError("no module declaration found")
    if len(outs) != 2:
        raise CosimParseError(f"expected max_count + argmax_idx outputs, "
                              f"found {[o[0] for o in outs]}")
    if not argmax_srcs:
        raise CosimParseError("no argmax block found")
    return ParsedNetlist(
        name=name, pen=pen, input_name=input_name, input_width=input_width,
        num_features=num_features, out_count=outs[0][0],
        out_index=outs[1][0], widths=widths, ops=ops,
        argmax_srcs=argmax_srcs, meta=meta)


# ---------------------------------------------------------------------------
# pure-Python netlist evaluator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EvalResult:
    """Batch outputs of one netlist evaluation."""

    max_count: np.ndarray         # (B,) int64
    argmax_idx: np.ndarray        # (B,) int64
    class_counts: np.ndarray      # (B, classes) int64


def evaluate_netlist(src_or_parsed, *, x=None, ten_bits=None) -> EvalResult:
    """Evaluate an emitted DWN netlist on a batch of inputs.

    Args:
      src_or_parsed: Verilog source (or an already-:func:`parse_netlist`
        result).
      x: (B, F) float features — PEN modules only; quantized to the
        module's (1, n) grid exactly like the oracle.
      ten_bits: (B, F*T) {0,1} thermometer bits — TEN modules only.

    Returns an :class:`EvalResult`.  Statements evaluate in source order
    (the emitter is topologically ordered); pipeline registers are
    steady-state copies (the datapath is feed-forward).
    """
    net = (src_or_parsed if isinstance(src_or_parsed, ParsedNetlist)
           else parse_netlist(src_or_parsed))
    env: dict = {}
    consts: dict = {}
    outs: dict = {}
    if net.pen:
        if x is None:
            raise ValueError(f"module {net.name} is PEN: pass x=(B, F) "
                             f"float features")
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != net.num_features:
            raise ValueError(f"x has shape {x.shape}; module {net.name} "
                             f"expects (B, {net.num_features})")
        B = x.shape[0]
        env[net.input_name] = fixed_point_int(x, net.input_width - 1)
    else:
        if ten_bits is None:
            raise ValueError(f"module {net.name} is TEN: pass "
                             f"ten_bits=(B, {net.input_width}) bits")
        bits = np.asarray(ten_bits)
        if bits.ndim != 2 or bits.shape[1] != net.input_width:
            raise ValueError(f"ten_bits has shape {bits.shape}; module "
                             f"{net.name} expects (B, {net.input_width})")
        B = bits.shape[0]
        env[net.input_name] = bits.astype(np.uint8)

    def vec(name: str) -> np.ndarray:
        if name not in env:
            if name not in net.widths:
                raise CosimParseError(f"signal {name!r} read before "
                                      f"declaration")
            # unassigned bits of a declared vector default to 0; the
            # emitter guarantees every *read* bit was assigned (LUT
            # selects are exactly the used-threshold mask)
            env[name] = np.zeros((B, net.widths[name]), np.uint8)
        return env[name]

    for op in net.ops:
        tag = op[0]
        if tag == "const":
            consts[op[1]] = op[2]
        elif tag == "cmp":
            _, dst, bit, src, feat, w, c = op
            vec(dst)[:, bit] = eval_comparator(env[src][:, feat], c, w)
        elif tag == "bit":
            _, dst, bit, s, sbit = op
            vec(dst)[:, bit] = vec(s)[:, sbit]
        elif tag == "lut":
            _, dst, bit, table_name, refs = op
            if table_name not in consts:
                raise CosimParseError(f"LUT constant {table_name!r} read "
                                      f"before its localparam")
            # refs are MSB-first in the concat: refs[p] is address bit
            # (n - 1 - p)
            sel = np.stack([vec(s)[:, b] for s, b in reversed(refs)],
                           axis=-1)
            vec(dst)[:, bit] = eval_lut(consts[table_name], sel)
        elif tag == "vec":
            _, dst, s = op
            env[dst] = vec(s).copy()
        elif tag == "sum":
            _, dst, refs = op
            env[dst] = eval_popcount(
                np.stack([vec(s)[:, b] for s, b in refs], axis=-1))
        elif tag == "out":
            # output-port assigns read the argmax registers, which settle
            # after the full combinational pass — resolve them at the end
            outs[op[1]] = op[2]
        else:                                        # pragma: no cover
            raise CosimParseError(f"unknown op {tag!r}")
        if tag == "sum":
            env[op[1]] = np.asarray(env[op[1]], np.int64)

    counts = np.stack([np.asarray(env[s], np.int64)
                       for s in net.argmax_srcs], axis=-1)
    best_v, best_i = eval_argmax(counts)
    env["best_v"], env["best_i"] = best_v, best_i
    for dst, s in outs.items():
        if s not in env:
            raise CosimParseError(f"output {dst!r} reads unassigned {s!r}")
        env[dst] = env[s]
    if net.out_count not in env or net.out_index not in env:
        raise CosimParseError("output ports never assigned")
    return EvalResult(max_count=np.asarray(env[net.out_count], np.int64),
                      argmax_idx=np.asarray(env[net.out_index], np.int64),
                      class_counts=counts)


# ---------------------------------------------------------------------------
# simulator backend (iverilog, auto-detected)
# ---------------------------------------------------------------------------

def simulator_available() -> str | None:
    """Name of the detected external simulator, or None.

    Currently Icarus Verilog (``iverilog`` + ``vvp``); the testbench is
    plain SystemVerilog-2012, so a verilator flow could slot in later —
    the pure-Python evaluator is the guaranteed CI path either way.
    """
    if shutil.which("iverilog") and shutil.which("vvp"):
        return "iverilog"
    return None


def emit_testbench(frozen, x, *, name: str = "dwn_top",
                   tb_name: str = "tb_dwn", pipeline: bool = True) -> str:
    """Emit a self-checking testbench driving ``x`` through the DUT.

    One ``COSIM <max_count> <argmax_idx>`` stdout line per vector (no
    VCD); each vector is held for enough clock cycles to flush the
    pipeline before sampling.
    """
    if hasattr(frozen, "spec"):
        frozen = frozen.frozen
    frozen = host_frozen(frozen)
    cfg = frozen.cfg
    spec = cfg.thermometer
    F, T = spec.num_features, spec.bits_per_feature
    classes = cfg.num_classes
    group = cfg.lut_counts[-1] // classes
    cnt_w = max(1, int(np.ceil(np.log2(group + 1))))
    idx_w = max(1, int(np.ceil(np.log2(classes))))
    pen = frozen.input_frac_bits is not None
    x = np.asarray(x)
    # pipeline depth: enc_q + one register per LUT layer + pc_q
    cycles = (2 + len(cfg.lut_counts)) + 2 if pipeline else 2

    lines: list[str] = []
    w = lines.append
    w("`timescale 1ns/1ps")
    w(f"module {tb_name};")
    w("  reg clk = 0;")
    w("  always #5 clk = ~clk;")
    if pen:
        in_w = 1 + frozen.input_frac_bits
        w(f"  reg signed [{in_w - 1}:0] x [0:{F - 1}];")
        port = ".x(x)"
        vals = fixed_point_int(x, frozen.input_frac_bits)
    else:
        w(f"  reg [{F * T - 1}:0] ten_bits;")
        port = ".ten_bits(ten_bits)"
        bits = encode_np(x, frozen.thresholds).astype(np.uint64)
    w(f"  wire [{cnt_w - 1}:0] max_count;")
    w(f"  wire [{idx_w - 1}:0] argmax_idx;")
    w(f"  {name} dut (.clk(clk), {port}, .max_count(max_count), "
      f".argmax_idx(argmax_idx));")
    w("  initial begin")
    for i in range(x.shape[0]):
        w(f"    // vector {i}")
        if pen:
            mask = (1 << in_w) - 1
            for f in range(F):
                w(f"    x[{f}] = {in_w}'h{int(vals[i, f]) & mask:x};")
        else:
            word = 0
            for k in range(F * T):
                if bits[i, k]:
                    word |= 1 << k
            w(f"    ten_bits = {F * T}'h{word:x};")
        w(f"    repeat ({cycles}) @(posedge clk);")
        w('    #1 $display("COSIM %0d %0d", max_count, argmax_idx);')
    w("    $finish;")
    w("  end")
    w("endmodule")
    return "\n".join(lines) + "\n"


def run_iverilog(dut_src: str, tb_src: str, *, tb_name: str = "tb_dwn",
                 timeout: float = 600.0) -> list[tuple[int, int]]:
    """Compile DUT + testbench with iverilog, run vvp, parse COSIM lines.

    Returns [(max_count, argmax_idx), ...] in vector order.  Raises
    :class:`SimulatorError` when the toolchain is missing or fails.
    """
    if simulator_available() is None:
        raise SimulatorError("no Verilog simulator found (need iverilog "
                             "+ vvp on PATH); use backend='python'")
    with tempfile.TemporaryDirectory(prefix="cosim_") as tmp:
        tmp = Path(tmp)
        (tmp / "dut.v").write_text(dut_src)
        (tmp / "tb.v").write_text(tb_src)
        out = tmp / "sim.out"
        comp = subprocess.run(
            ["iverilog", "-g2012", "-s", tb_name, "-o", str(out),
             str(tmp / "dut.v"), str(tmp / "tb.v")],
            capture_output=True, text=True, timeout=timeout)
        if comp.returncode != 0:
            raise SimulatorError(f"iverilog compile failed:\n{comp.stderr}")
        run = subprocess.run(["vvp", str(out)], capture_output=True,
                             text=True, timeout=timeout)
        if run.returncode != 0:
            raise SimulatorError(f"vvp failed:\n{run.stderr}")
    results = []
    for line in run.stdout.splitlines():
        if line.startswith("COSIM "):
            _, a, b = line.split()
            results.append((int(a), int(b)))
    if not results:
        raise SimulatorError(f"no COSIM output lines from vvp:\n"
                             f"{run.stdout[:2000]}")
    return results


# ---------------------------------------------------------------------------
# verify_rtl: the golden-model gate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CosimReport:
    """Outcome of one :func:`verify_rtl` run (only returned on success —
    any disagreement raises :class:`RTLMismatch` instead)."""

    model: str
    variant: str
    n_vectors: int
    backends: list
    counts_checked: bool          # per-class counts compared (python path)
    spec: str | None = None
    src: str = dataclasses.field(default="", repr=False)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("src")
        return d


def _resolve_frozen(target):
    """(frozen, spec_label, oracle device) from a FrozenDWN or a
    DWNArtifact: the oracle runs where the model lives — an artifact's
    packed operands' device once it is packed, else the frozen arrays'
    (``core.model.frozen_device``)."""
    if hasattr(target, "spec"):
        if target.frozen is None:
            raise ValueError(
                f"artifact {target.spec.label} is at stage "
                f"{target.stage!r}; call freeze() before verify_rtl()")
        device = (target.packed.device if target.packed is not None
                  else frozen_device(target.frozen))
        return target.frozen, target.spec.label, device
    return target, None, frozen_device(target)


def verify_rtl(target, x=None, *, n: int = 256, backend: str = "auto",
               pipeline: bool = True, name: str = "dwn_top",
               seed: int = 0, src: str | None = None,
               max_report: int = 5) -> CosimReport:
    """Prove the emitted RTL computes what ``apply_hard_packed`` computes.

    Args:
      target: a ``DWNArtifact`` at stage >= frozen, or a ``FrozenDWN``
        (numpy or tensors on any device).  The oracle runs on the model's
        device (see :func:`_resolve_frozen`); the netlist evaluator on
        the host.
      x: (B, F) float feature vectors; defaults to ``n`` real test
        vectors of the artifact spec's workload (JSC for a bare
        16-feature ``FrozenDWN``, seeded uniform vectors otherwise).
      n: number of default vectors when ``x`` is None.
      backend: "python" (pure evaluator), "iverilog" (external simulator,
        raises :class:`SimulatorError` if absent), or "auto" (python
        always + the simulator when detected).
      pipeline: emit/verify the pipelined module.
      name: emitted module name.
      src: pre-emitted Verilog to verify instead of emitting here (for
        mutation testing — must match ``name``/``pipeline``).
      max_report: mismatching vectors quoted in the failure message.

    Returns a :class:`CosimReport` (carrying the verified source in
    ``.src``).  Raises :class:`RTLMismatch` on ANY disagreement in
    argmax index, winning count, or (python backend) per-class counts.
    """
    frozen, spec_label, device = _resolve_frozen(target)
    if x is None:
        if hasattr(target, "spec"):
            # artifact: real test vectors of the spec's own workload
            from ..workloads import load_workload
            x = load_workload(target.spec.workload, 512, max(n, 1),
                              seed=seed).x_test[:n]
        elif frozen.cfg.num_features == 16:
            # bare FrozenDWN at the JSC geometry: the legacy default
            from ..data.jsc import load_jsc
            x = load_jsc(512, max(n, 1), seed=seed).x_test[:n]
        else:
            # bare FrozenDWN of unknown provenance: seeded vectors over
            # the encoder's input domain
            rng = np.random.default_rng(seed)
            x = rng.uniform(-1.0, 1.0,
                            (n, frozen.cfg.num_features)).astype(np.float32)
    x = np.asarray(x, np.float32)
    host = host_frozen(frozen)
    if src is None:
        src = emit_dwn(host, name=name, pipeline=pipeline)

    with torch.no_grad():
        counts = apply_hard_packed(frozen, torch.from_numpy(x).to(device))
    counts = counts.cpu().numpy().astype(np.int64)
    oracle_max, oracle_idx = eval_argmax(counts)

    if backend == "auto":
        backends = ["python"] + (["iverilog"] if simulator_available()
                                 else [])
    elif backend in ("python", "iverilog"):
        backends = [backend]
    else:
        raise ValueError(f"unknown cosim backend {backend!r}; choose "
                         f"'python', 'iverilog', or 'auto'")

    pen = frozen.input_frac_bits is not None
    counts_checked = False
    for b in backends:
        if b == "python":
            if pen:
                res = evaluate_netlist(src, x=x)
            else:
                res = evaluate_netlist(
                    src, ten_bits=encode_np(x, host.thresholds))
            got_max, got_idx = res.max_count, res.argmax_idx
            got_counts = res.class_counts
            counts_checked = True
        else:
            tb = emit_testbench(host, x, name=name, pipeline=pipeline)
            pairs = run_iverilog(src, tb)
            if len(pairs) != x.shape[0]:
                raise RTLMismatch(
                    f"[iverilog] {len(pairs)} output lines for "
                    f"{x.shape[0]} vectors")
            got_max = np.array([p[0] for p in pairs], np.int64)
            got_idx = np.array([p[1] for p in pairs], np.int64)
            got_counts = None

        bad = np.nonzero((got_idx != oracle_idx)
                         | (got_max != oracle_max))[0]
        if got_counts is not None and bad.size == 0:
            bad = np.nonzero((got_counts != counts).any(axis=-1))[0]
        if bad.size:
            rows = []
            for i in bad[:max_report]:
                rows.append(
                    f"  vector {i}: oracle argmax={oracle_idx[i]} "
                    f"max={oracle_max[i]} counts={counts[i].tolist()}; "
                    f"rtl argmax={got_idx[i]} max={got_max[i]}"
                    + (f" counts={got_counts[i].tolist()}"
                       if got_counts is not None else ""))
            raise RTLMismatch(
                f"[{b}] emitted RTL disagrees with apply_hard_packed on "
                f"{bad.size}/{x.shape[0]} vectors "
                f"({spec_label or name}):\n" + "\n".join(rows))

    return CosimReport(
        model=name, variant="PEN" if pen else "TEN",
        n_vectors=int(x.shape[0]), backends=backends,
        counts_checked=counts_checked, spec=spec_label, src=src)


# ---------------------------------------------------------------------------
# CLI: the co-simulation gate
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Co-simulate emitted DWN RTL against the packed "
                    "oracle on real vectors of each preset's workload.")
    ap.add_argument("--presets", default="dwn-jsc-sm,dwn-jsc-md,dwn-jsc-lg",
                    help="comma-separated registered spec presets (any "
                         "workload, e.g. dwn-mnist-sm)")
    ap.add_argument("--variants", default="TEN,PEN",
                    help="encoding variants to verify per preset")
    ap.add_argument("--input-bits", type=int, default=9,
                    help="PEN fixed-point input width (total bits)")
    ap.add_argument("--n", type=int, default=256,
                    help="workload test vectors per verification")
    ap.add_argument("--n-train", type=int, default=2000,
                    help="workload training samples (threshold fit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "python", "iverilog"])
    ap.add_argument("--no-pipeline", action="store_true",
                    help="verify the unpipelined (combinational) module")
    ap.add_argument("--require-simulator", action="store_true",
                    help="fail (exit 2) instead of skipping when no "
                         "external simulator is on PATH")
    ap.add_argument("--out", default="",
                    help="write the per-preset report JSON here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the oracle runs (default cuda; never "
                         "falls back)")
    args = ap.parse_args(argv)

    import dataclasses as dc

    from ..dwn import DWNArtifact
    from ..dwn.spec import get_spec
    from ..workloads import load_workload

    if args.require_simulator and simulator_available() is None:
        print("cosim: --require-simulator set but no iverilog/vvp on "
              "PATH", file=sys.stderr)
        return 2
    if args.backend == "iverilog" and simulator_available() is None:
        print("cosim: backend=iverilog requested but no iverilog/vvp on "
              "PATH", file=sys.stderr)
        return 2

    splits: dict = {}                          # workload name -> split

    def data_for(workload: str):
        if workload not in splits:
            splits[workload] = load_workload(
                workload, args.n_train, max(args.n, 1), seed=args.seed)
        return splits[workload]

    models: dict = {}
    rows, failures = [], 0
    for preset in [p for p in args.presets.split(",") if p]:
        base = get_spec(preset)
        data = data_for(base.workload)
        for variant in [v for v in args.variants.split(",") if v]:
            spec = base if base.variant == variant else dc.replace(
                base, variant=variant,
                input_bits=None if variant == "TEN" else args.input_bits)
            mkey = (spec.workload, spec.preset, spec.bits, spec.placement)
            if mkey not in models:
                ten = dc.replace(spec, variant="TEN", input_bits=None)
                a = DWNArtifact(ten).fit(data.x_train, seed=args.seed)
                models[mkey] = (a.params, a.buffers)
            art = DWNArtifact(spec)
            art.adopt(*models[mkey], note="cosim").freeze().pack(args.device)
            try:
                rep = verify_rtl(art, data.x_test[:args.n],
                                 backend=args.backend,
                                 pipeline=not args.no_pipeline)
                rows.append(rep.to_dict() | {"agree": True})
                print(f"cosim OK   {spec.label}: {rep.n_vectors} vectors "
                      f"bit-exact on {'+'.join(rep.backends)}", flush=True)
            except RTLMismatch as e:
                failures += 1
                rows.append({"spec": spec.label, "agree": False,
                             "error": str(e)})
                print(f"cosim FAIL {spec.label}:\n{e}", file=sys.stderr,
                      flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"n_vectors": args.n, "backend": args.backend,
             "simulator": simulator_available(), "results": rows},
            indent=1))
        print(f"written {args.out}")
    return 1 if failures else 0


__all__ = [
    "CosimError", "CosimParseError", "CosimReport", "EvalResult",
    "ParsedNetlist", "RTLMismatch", "SimulatorError", "as_signed",
    "emit_testbench", "eval_argmax", "eval_comparator", "eval_lut",
    "eval_popcount", "evaluate_netlist", "fixed_point_int", "main",
    "parse_netlist", "run_iverilog", "simulator_available", "verify_rtl",
]

if __name__ == "__main__":
    sys.exit(main())
