"""Verilog emitter for the full DWN accelerator (the hardware generator).

The port's copy of the reference's ``repro.hw.verilog``: the same frozen
model gives the same source, byte for byte (the header comment included,
so the reference's golden file is reproduced).  Emits one synthesizable
module per FrozenDWN:

  * PEN variants: signed fixed-point feature inputs (1, n) and the
    distributive thermometer comparator bank (only *used, distinct*
    comparators are instantiated; duplicate thresholds are CSE'd and
    fan out, exactly like the paper's generator — Fig. 3);
  * TEN variant: thermometer-encoded bit inputs;
  * the LUT layer as 64-bit INIT constants indexed by the 6 selected wires
    (a LUT6 apiece after synthesis);
  * per-class popcount (adder reduction; synthesizes to the compressor
    tree the cost model prices);
  * argmax with ties to the lower class index (paper §IV);
  * optional pipeline registers at component boundaries.

The RTL is structurally synthesizable and covered by well-formedness
tests and the co-simulation of ``hw.cosim``; LUT counts come from the
cost model (``hw.cost``), not from synthesis.  A ``FrozenDWN`` whose
arrays are tensors on the card is brought to the host first, and wire
indices and constants are formatted as Python ``int``s.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.model import host_frozen
from ..core.thermometer import used_threshold_mask


def _fixed_point_const(value: float, frac_bits: int) -> int:
    """(1, n) signed fixed point -> two's-complement integer literal."""
    w = 1 + frac_bits
    q = int(round(value * (1 << frac_bits)))
    q = max(-(1 << frac_bits), min((1 << frac_bits) - 1, q))
    return q & ((1 << w) - 1)


def emit_dwn(frozen, *, name: str = "dwn_top",
             pipeline: bool = True) -> str:
    """Emit the accelerator for a FrozenDWN (numpy or tensors on any
    device) or a ``repro_torch.dwn`` artifact at stage >= "frozen".
    Returns Verilog source."""
    if hasattr(frozen, "spec"):          # a DWNArtifact, not a FrozenDWN
        art = frozen
        if art.frozen is None:
            raise ValueError(
                f"artifact {art.spec.label} is at stage {art.stage!r}; "
                f"call freeze() before emitting Verilog")
        frozen = art.frozen
    frozen = host_frozen(frozen)

    cfg = frozen.cfg
    spec = cfg.thermometer
    F, T = spec.num_features, spec.bits_per_feature
    classes = cfg.num_classes
    m_final = cfg.lut_counts[-1]
    group = m_final // classes
    cnt_w = max(1, math.ceil(math.log2(group + 1)))
    idx_w = max(1, math.ceil(math.log2(classes)))
    pen = frozen.input_frac_bits is not None
    lines: list[str] = []
    w = lines.append

    w("// generated by repro.hw.verilog — DWN accelerator")
    w(f"// model={name} variant={'PEN' if pen else 'TEN'} "
      f"luts={cfg.lut_counts} classes={classes}")
    w(f"// io F={F} T={T} layers={len(cfg.lut_counts)} "
      f"frac={frozen.input_frac_bits if pen else -1} "
      f"pipeline={int(pipeline)}")
    w(f"module {name} (")
    w("    input  wire clk,")
    if pen:
        in_w = 1 + frozen.input_frac_bits
        w(f"    input  wire signed [{in_w - 1}:0] x [{F}],")
    else:
        w(f"    input  wire [{F * T - 1}:0] ten_bits,")
    w(f"    output wire [{cnt_w - 1}:0] max_count,")
    w(f"    output wire [{idx_w - 1}:0] argmax_idx")
    w(");")

    # ---------------- thermometer encoder ----------------
    mask = used_threshold_mask(np.asarray(frozen.mapping_idx[0]), spec)
    if pen:
        frac = frozen.input_frac_bits
        w(f"  // distributive thermometer encoders ((1,{frac}) inputs);")
        w("  // one comparator per distinct used threshold (CSE'd)")
        w(f"  wire [{F * T - 1}:0] enc;")
        emitted: dict[tuple[int, int], str] = {}
        n_cmp = 0
        for f in range(F):
            for t in range(T):
                if not mask[f, t]:
                    continue
                c = _fixed_point_const(float(frozen.thresholds[f, t]), frac)
                key = (f, c)
                sig = f"enc[{f * T + t}]"
                if key in emitted:
                    w(f"  assign {sig} = {emitted[key]}; // dup threshold")
                    continue
                n_cmp += 1
                w(f"  assign {sig} = ($signed(x[{f}]) > "
                  f"$signed({1 + frac}'h{c:x})); // f{f} th{t}")
                emitted[key] = sig
        w(f"  // {n_cmp} distinct comparators")
    else:
        w(f"  wire [{F * T - 1}:0] enc = ten_bits;")

    stage0 = "enc_q" if pipeline else "enc"
    if pipeline:
        w(f"  reg [{F * T - 1}:0] enc_q;")
        w("  always @(posedge clk) enc_q <= enc;")

    # ---------------- LUT layers ----------------
    prev = stage0
    prev_w = F * T
    for li, (idx, tab) in enumerate(zip(frozen.mapping_idx,
                                        frozen.tables_bin)):
        m, n = np.asarray(idx).shape
        tabs = np.asarray(tab)
        w(f"  // LUT layer {li}: {m} x LUT{n}")
        w(f"  wire [{m - 1}:0] l{li};")
        for j in range(m):
            init = 0
            for a in range(2 ** n):
                if tabs[j, a]:
                    init |= 1 << a
            sel = ", ".join(f"{prev}[{int(idx[j, i])}]"
                            for i in reversed(range(n)))
            w(f"  localparam [{2 ** n - 1}:0] INIT_{li}_{j} = "
              f"{2 ** n}'h{init:016x};")
            w(f"  assign l{li}[{j}] = INIT_{li}_{j}[{{{sel}}}];")
        if pipeline:
            w(f"  reg [{m - 1}:0] l{li}_q;")
            w(f"  always @(posedge clk) l{li}_q <= l{li};")
            prev = f"l{li}_q"
        else:
            prev = f"l{li}"
        prev_w = m

    # ---------------- popcount ----------------
    w(f"  // per-class popcount over groups of {group}")
    for c in range(classes):
        terms = " + ".join(f"{prev}[{c * group + i}]" for i in range(group))
        w(f"  wire [{cnt_w - 1}:0] pc_{c} = {terms};")
    if pipeline:
        for c in range(classes):
            w(f"  reg [{cnt_w - 1}:0] pc_{c}_q;")
            w(f"  always @(posedge clk) pc_{c}_q <= pc_{c};")
        pc = [f"pc_{c}_q" for c in range(classes)]
    else:
        pc = [f"pc_{c}" for c in range(classes)]

    # ---------------- argmax (ties -> lower index) ----------------
    w("  // argmax comparator tree; strict > keeps the lower index on ties")
    w(f"  reg [{cnt_w - 1}:0] best_v;")
    w(f"  reg [{idx_w - 1}:0] best_i;")
    w("  always @* begin")
    w(f"    best_v = {pc[0]}; best_i = {idx_w}'d0;")
    for c in range(1, classes):
        w(f"    if ({pc[c]} > best_v) begin "
          f"best_v = {pc[c]}; best_i = {idx_w}'d{c}; end")
    w("  end")
    w("  assign max_count = best_v;")
    w("  assign argmax_idx = best_i;")
    w("endmodule")
    return "\n".join(lines) + "\n"


def well_formed(src: str) -> bool:
    """Cheap structural checks used by unit tests.

    Not a parser (``hw.cosim.parse_netlist`` is); this is the fast gate:
    every ``module`` has its ``endmodule``, every ``begin`` its ``end``,
    brackets balance, and input/output ports exist.
    """
    import re

    modules = len(re.findall(r"^\s*module\s+\w+", src, re.MULTILINE))
    endmodules = len(re.findall(r"^\s*endmodule\b", src, re.MULTILINE))
    if modules == 0 or modules != endmodules:
        return False
    # \bend\b does not match the "end" inside "endmodule"
    begins = len(re.findall(r"\bbegin\b", src))
    ends = len(re.findall(r"\bend\b", src))
    if begins != ends:
        return False
    for opener, closer in ("()", "[]", "{}"):
        if src.count(opener) != src.count(closer):
            return False
    return bool(re.search(r"^\s*input\b", src, re.MULTILINE)
                and re.search(r"^\s*output\b", src, re.MULTILINE))


__all__ = ["emit_dwn", "well_formed"]
