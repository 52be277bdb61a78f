"""Technology-mapped FPGA cost model (Xilinx UltraScale+ xcvu9p, LUT6).

The port's numpy copy of the reference's ``repro.hw.cost``: the same
constants and rules, so the same frozen model gets the same report in
both packages.  It mirrors the paper's FloPoCo-based generator
structurally:

* thermometer encoder  -> one constant comparator per *distinct, used*
  (feature, threshold) pair (Fig. 3; dedup after PTQ quantization);
* LUT layer            -> m physical LUT6 (exact);
* popcount             -> GPC compressor tree (6:3 and 3:2 compressors,
  3 resp. 1 LUT each, per FloPoCo's compressor-tree chapter [24]) run to
  completion, then a final carry adder (1 LUT/bit);
* argmax               -> pairwise comparator/mux reduction tree (Fig. 4).

Fmax/FF figures are estimates from pipeline-register placement and logic
depth and are labelled as such.  A ``FrozenDWN`` whose arrays are tensors
on the card is brought to the host once (``core.model.host_frozen``).
"""

from __future__ import annotations

import dataclasses
import math

from ..core.model import host_frozen
from ..core.thermometer import distinct_used_thresholds, used_threshold_mask

# --- technology constants ---------------------------------------------------
# All delays in nanoseconds (xcvu9p speed-grade-2 ballpark figures).
T_LUT_NS = 0.20          # LUT6 switching delay
T_ROUTE_NS = 0.45        # average routed-net delay
T_CARRY_NS = 0.05        # per CARRY8 block


def comparator_luts(width: int) -> int:
    """Physical LUT6 count of a constant comparator ``x >= const``.

    width<=6 : any boolean function of <=6 inputs is exactly one LUT6.
    Wider    : 6-bit segments produce (gt, eq) via dual-output LUT6_2;
               the combine chain folds into one extra LUT per segment pair
               (carry-assisted).  Net effect: ceil(width/6) + segments-1.

    Args:
      width: input bit-width of ``x`` (total bits, sign included).

    Returns the LUT6 count (0 for non-positive widths).
    """
    if width <= 0:
        return 0
    seg = math.ceil(width / 6)
    return seg + max(0, seg - 1)


def comparator_levels(width: int) -> int:
    """Combinational logic depth (LUT levels, unitless) of the same
    constant comparator: one level of segment LUTs plus a log2 combine
    tree over the segments."""
    seg = math.ceil(width / 6)
    return 1 + (0 if seg == 1 else math.ceil(math.log2(seg)))


def two_input_comparator_luts(width: int) -> int:
    """LUT6 count of a two-variable comparator ``x > y``.

    Args:
      width: bit-width of *each* operand — the function sees 2*width
        input bits, segmented six at a time like :func:`comparator_luts`.

    Returns the LUT6 count.
    """
    if width <= 0:
        return 0
    seg = math.ceil(2 * width / 6)
    return seg + max(0, seg - 1)


def mux2_luts(width: int) -> int:
    """LUT6 count of a 2:1 mux of a ``width``-bit value: sel+2 data = 3
    inputs/bit; one dual-output LUT6_2 packs two bits."""
    return math.ceil(width / 2)


# --- popcount: GPC compressor-tree simulation --------------------------------

@dataclasses.dataclass
class CompressorTreeResult:
    luts: int                  # physical LUT6 count
    stages: int                # compressor stages (logic levels, unitless)
    out_bits: int              # result bit-width


def popcount_tree(n_bits: int) -> CompressorTreeResult:
    """Greedy GPC schedule: per stage, cover each column with 6:3 (3 LUTs)
    then 3:2 (1 LUT) compressors until every column has <= 2 bits, then a
    final ripple-carry add (1 LUT/bit via CARRY8).

    Args:
      n_bits: number of 1-bit inputs to count.

    Returns a :class:`CompressorTreeResult` (total LUT6s, compressor
    stages, result width in bits).
    """
    if n_bits <= 1:
        return CompressorTreeResult(0, 0, max(n_bits, 1))
    if n_bits <= 3:
        # half/full adder: sum+carry are two functions of <=3 shared
        # inputs -> one dual-output LUT6_2
        return CompressorTreeResult(1, 1, 2)
    if n_bits <= 6:
        # one 6:3 compressor = the 3-bit count (3 x 6-input functions)
        return CompressorTreeResult(3, 1, 3)
    out_width = math.ceil(math.log2(n_bits + 1))
    cols = [n_bits] + [0] * (out_width - 1)   # bits per column (weight 2^i)
    luts = 0
    stages = 0
    while max(cols) > 2:
        stages += 1
        nxt = [0] * len(cols)
        for c, h in enumerate(cols):
            while h >= 6:
                h -= 6
                luts += 3
                for d in range(3):            # 3-bit count -> cols c..c+2
                    if c + d < len(nxt):
                        nxt[c + d] += 1
            while h >= 3:
                h -= 3
                luts += 1
                for d in range(2):
                    if c + d < len(nxt):
                        nxt[c + d] += 1
            nxt[c] += h                       # passthrough leftovers
        cols = nxt
    # final 2-row carry-propagate add
    width = max(i for i, h in enumerate(cols) if h) + 1
    luts += width
    return CompressorTreeResult(luts, stages + 1, out_width)


# --- component-level costs ----------------------------------------------


@dataclasses.dataclass
class ComponentCost:
    """One component's price: physical LUT6s, flip-flops, and
    combinational logic levels (unitless depth; multiply by per-level
    delay to get ns)."""

    luts: int
    ffs: int
    levels: int                # combinational logic levels

    def __add__(self, o: "ComponentCost") -> "ComponentCost":
        return ComponentCost(self.luts + o.luts, self.ffs + o.ffs,
                             self.levels + o.levels)


def encoder_cost(distinct_per_feature: list[int], input_bits: int,
                 used_bits: int, *, pipeline: bool = True) -> ComponentCost:
    """Thermometer encoder bank (the PEN on-chip encoder).

    Args:
      distinct_per_feature: number of *distinct used* threshold values per
        feature after PTQ dedup (CSE); each is one constant comparator.
      input_bits: fixed-point input width in total bits (sign included) —
        sets the per-comparator LUT count.
      used_bits: encoder output bits actually wired to the LUT layer
        (registered at the component boundary when pipelined — the FF
        count).

    Returns the encoder's :class:`ComponentCost`.
    """
    n_cmp = int(sum(distinct_per_feature))
    luts = n_cmp * comparator_luts(input_bits)
    ffs = used_bits if pipeline else 0
    return ComponentCost(luts, ffs, comparator_levels(input_bits))


def lut_layer_cost(num_luts: int, *, pipeline: bool = True) -> ComponentCost:
    """One LUT layer: ``num_luts`` (m) physical LUT6s exactly, one logic
    level, one output register per LUT when pipelined."""
    return ComponentCost(num_luts, num_luts if pipeline else 0, 1)


def popcount_cost(group_size: int, num_classes: int,
                  *, pipeline: bool = True) -> ComponentCost:
    """Per-class popcount bank: one ``group_size``-input GPC compressor
    tree per class (see :func:`popcount_tree`); FFs register each class's
    count when pipelined."""
    tree = popcount_tree(group_size)
    luts = tree.luts * num_classes
    ffs = tree.out_bits * num_classes if pipeline else 0
    return ComponentCost(luts, ffs, tree.stages)


def argmax_cost(num_classes: int, count_bits: int,
                *, pipeline: bool = True) -> ComponentCost:
    """Pairwise reduction (Fig. 4): c-1 nodes of (comparator + value mux +
    index mux); index width grows toward the root.

    Args:
      num_classes: number of class counts reduced.
      count_bits: bit-width of each count (ceil(log2(group_size + 1))).

    Returns the argmax tree's :class:`ComponentCost`.
    """
    luts = 0
    idx_bits = 1
    n = num_classes
    level = 0
    while n > 1:
        pairs = n // 2
        luts += pairs * (two_input_comparator_luts(count_bits)
                         + mux2_luts(count_bits)
                         + mux2_luts(idx_bits))
        n = pairs + n % 2
        idx_bits += 1
        level += 1
    ffs = (count_bits + math.ceil(math.log2(num_classes))) if pipeline else 0
    lv = level * (1 + 1)          # compare + mux per tree level
    return ComponentCost(luts, ffs, lv)


# --- whole-accelerator reports -------------------------------------------


@dataclasses.dataclass
class HWReport:
    """Whole-accelerator cost report.

    Attributes:
      variant: "TEN" | "PEN" | "PEN+FT".
      model: model/preset name the report describes.
      input_bits: PEN fixed-point input width in total bits; None for TEN.
      luts / ffs: per-component physical LUT6 / flip-flop counts, keyed
        "encoder" | "lut_layer" | "popcount" | "argmax".
      levels: end-to-end combinational logic depth (unitless).
      distinct_comparators: encoder comparators after PTQ dedup.
    """

    variant: str                         # "TEN" | "PEN" | "PEN+FT"
    model: str
    input_bits: int | None
    luts: dict                           # component -> LUTs
    ffs: dict
    levels: int
    distinct_comparators: int = 0

    @property
    def total_luts(self) -> int:
        """Total physical LUT6 count over all components."""
        return int(sum(self.luts.values()))

    @property
    def total_ffs(self) -> int:
        """Total flip-flop count over all components."""
        return int(sum(self.ffs.values()))

    @property
    def delay_ns(self) -> float:
        """Unpipelined end-to-end combinational delay estimate in **ns**
        (levels x per-level LUT+route delay) — the latency column."""
        return self.levels * (T_LUT_NS + T_ROUTE_NS)

    @property
    def fmax_mhz(self) -> float:
        """Pipelined clock estimate in **MHz**: with registers between
        components the critical stage is the deepest single component."""
        return 1e3 / max(self.delay_ns / max(self.levels, 1) *  # per level
                         self._max_stage_levels(), 0.1)

    def _max_stage_levels(self) -> int:
        return max(1, self._stage_levels)

    _stage_levels: int = 1

    @property
    def area_delay(self) -> float:
        """A x D product in **LUT·ns** at the pipelined critical-stage
        delay (Table I's AxD column)."""
        return self.total_luts * (1e3 / self.fmax_mhz)


def dwn_hw_report(frozen, *, variant: str | None = None,
                  name: str | None = None,
                  input_bits: int | None = None,
                  pipeline: bool = True) -> HWReport:
    """Full-accelerator cost for a FrozenDWN or a ``repro_torch.dwn``
    artifact.

    TEN: inputs are already thermometer bits -> no encoder.
    PEN/PEN+FT: on-chip encoder at `input_bits` total width (1, n).

    Args:
      frozen: the FrozenDWN whose mapping/thresholds set encoder dedup
        (numpy or tensors on any device) — or a
        ``repro_torch.dwn.DWNArtifact`` at stage >= "frozen", in which
        case ``variant``/``name``/``input_bits`` default to its spec.
      variant: "TEN" | "PEN" | "PEN+FT" (PEN variants price the encoder);
        required unless an artifact is given.
      name: model name recorded in the report; required unless an
        artifact is given.
      input_bits: PEN input width in total bits (required unless TEN).
      pipeline: register component boundaries (sets FF counts and makes
        ``fmax_mhz`` the per-stage estimate).

    Returns the :class:`HWReport` (LUT/FF counts, depth, ns/MHz figures).
    """
    spec = getattr(frozen, "spec", None)
    if spec is not None:                 # a DWNArtifact, not a FrozenDWN
        art = frozen
        if art.frozen is None:
            raise ValueError(
                f"artifact {spec.label} is at stage {art.stage!r}; call "
                f"freeze() before hw_report")
        frozen = art.frozen
        variant = variant if variant is not None else spec.variant
        name = name if name is not None else spec.preset
        if input_bits is None:
            input_bits = spec.input_bits
    if variant is None or name is None:
        raise TypeError("dwn_hw_report needs variant= and name= when "
                        "given a bare FrozenDWN (or pass a DWNArtifact, "
                        "whose spec carries both)")

    frozen = host_frozen(frozen)
    cfg = frozen.cfg
    luts: dict = {}
    ffs: dict = {}
    levels = 0
    n_cmp = 0

    m_final = cfg.lut_counts[-1]
    group = m_final // cfg.num_classes
    count_bits = math.ceil(math.log2(group + 1))

    if variant != "TEN":
        assert input_bits is not None
        spec = cfg.thermometer
        mask = used_threshold_mask(frozen.mapping_idx[0], spec)
        frac = input_bits - 1
        n_cmp, per_feature = distinct_used_thresholds(
            frozen.thresholds, mask, frac_bits=frac)
        used_bits = int(mask.sum())
        c = encoder_cost(per_feature, input_bits, used_bits,
                         pipeline=pipeline)
        luts["encoder"], ffs["encoder"] = c.luts, c.ffs
        levels += c.levels
        enc_levels = c.levels
    else:
        # inputs arrive as TEN bits; register them at the boundary
        used = used_threshold_mask(frozen.mapping_idx[0],
                                   cfg.thermometer)
        luts["encoder"], ffs["encoder"] = 0, int(used.sum()) if pipeline else 0
        enc_levels = 0

    lut_total = 0
    for m in cfg.lut_counts:
        lut_total += m
    c = lut_layer_cost(lut_total, pipeline=pipeline)
    luts["lut_layer"], ffs["lut_layer"] = c.luts, c.ffs
    levels += c.levels * len(cfg.lut_counts)

    c = popcount_cost(group, cfg.num_classes, pipeline=pipeline)
    luts["popcount"], ffs["popcount"] = c.luts, c.ffs
    pop_levels = c.levels
    levels += c.levels

    c = argmax_cost(cfg.num_classes, count_bits, pipeline=pipeline)
    luts["argmax"], ffs["argmax"] = c.luts, c.ffs
    levels += c.levels

    rep = HWReport(variant, name, input_bits, luts, ffs, levels,
                   distinct_comparators=n_cmp)
    rep._stage_levels = max(enc_levels, 1, pop_levels, c.levels)
    return rep


__all__ = [
    "ComponentCost", "CompressorTreeResult", "HWReport", "argmax_cost",
    "comparator_levels", "comparator_luts", "dwn_hw_report", "encoder_cost",
    "lut_layer_cost", "mux2_luts", "popcount_cost", "popcount_tree",
    "two_input_comparator_luts",
]
