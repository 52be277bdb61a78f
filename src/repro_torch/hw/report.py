"""Assembled hardware reports: the paper's Tables I/III and Fig. 5 rows.

The port's copy of the reference's ``repro.hw.report``.  Paper reference
values (AMD xcvu9p, Vivado OOC, Flow_PerfOptimized_high) are kept here as
constants so a report prints the generator's numbers *next to* the
paper's with % error.
"""

from __future__ import annotations

import dataclasses

from .cost import dwn_hw_report, HWReport

# --- paper constants (Tables I and III) -----------------------------------

#: Table I — TEN vs PEN+FT. (LUT, FF, Fmax MHz, latency ns, AxD LUT*ns)
PAPER_TABLE1 = {
    ("lg-2400", "TEN"): dict(luts=4972, ffs=3305, fmax=827, lat=7.3, axd=36296),
    ("lg-2400", "PEN+FT"): dict(luts=7011, ffs=961, fmax=947, lat=2.1,
                                axd=14723, bits=9),
    ("md-360", "TEN"): dict(luts=720, ffs=457, fmax=827, lat=3.6, axd=2592),
    ("md-360", "PEN+FT"): dict(luts=1697, ffs=198, fmax=696, lat=2.6,
                               axd=4412, bits=9),
    ("sm-50", "TEN"): dict(luts=110, ffs=72, fmax=1094, lat=1.5, axd=165),
    ("sm-50", "PEN+FT"): dict(luts=311, ffs=52, fmax=1011, lat=2.0,
                              axd=622, bits=8),
    ("sm-10", "TEN"): dict(luts=20, ffs=22, fmax=3030, lat=0.6, axd=12),
    ("sm-10", "PEN+FT"): dict(luts=64, ffs=18, fmax=1251, lat=1.6,
                              axd=102, bits=6),
}

#: Table III — LUTs and input bit-width for PEN+FT / PEN / TEN.
PAPER_TABLE3 = {
    "sm-10": dict(ft_acc=71.2, ft_luts=64, ft_bits=6,
                  pen_acc=71.3, pen_luts=106, pen_bits=9,
                  ten_acc=71.1, ten_luts=20),
    "sm-50": dict(ft_acc=74.0, ft_luts=311, ft_bits=8,
                  pen_acc=74.0, pen_luts=345, pen_bits=9,
                  ten_acc=74.0, ten_luts=110),
    "md-360": dict(ft_acc=75.6, ft_luts=1697, ft_bits=9,
                   pen_acc=75.6, pen_luts=1994, pen_bits=11,
                   ten_acc=75.6, ten_luts=720),
    "lg-2400": dict(ft_acc=76.3, ft_luts=7011, ft_bits=9,
                    pen_acc=76.3, pen_luts=18330, pen_bits=12,
                    ten_acc=76.3, ten_luts=4972),
}

#: Table II — competing LUT-based architectures on JSC (literature rows).
PAPER_TABLE2 = [
    # (model, acc %, LUT, FF, Fmax MHz, latency ns, AxD)
    ("DWN-PEN+FT (lg-2400) (9-Bit)", 76.3, 7011, 961, 947, 2.1, 14723),
    ("NeuraLUT-Assemble", 76.0, 1780, 540, 941, 2.1, 3738),
    ("TreeLUT", 76.0, 2234, 347, 735, 2.7, 6032),
    ("DWN-PEN+FT (md-360) (9-Bit)", 75.6, 1697, 198, 696, 2.6, 4412),
    ("TreeLUT", 75.0, 796, 74, 887, 1.1, 876),
    ("PolyLUT-Add", 75.0, 36484, 1209, 315, 16.0, 583744),
    ("NeuraLUT", 75.0, 92357, 4885, 368, 14.0, 1292998),
    ("PolyLUT", 75.0, 236541, 2775, 235, 21.0, 4967361),
    ("LLNN", 75.0, 13926, 0, 153, 6.5, 90519),
    ("ReducedLUT", 74.9, 58409, 0, 303, 17.0, 992963),
    ("AmigoLUT-NeuraLUT-S", 74.4, 42742, 4717, 520, 9.6, 410323),
    ("DWN-PEN+FT (sm-50) (8-Bit)", 74.0, 311, 52, 1011, 2.0, 622),
    ("LogicNets*", 73.1, 36415, 2790, 390, 6.0, 218490),
    ("AmigoLUT-NeuraLUT-XS", 72.9, 1243, 1240, 1008, 5.0, 6215),
    ("ReducedLUT", 72.5, 2786, 0, 409, 4.9, 13651),
    ("LogicNets*", 72.1, 15526, 881, 577, 5.0, 77630),
    ("PolyLUT", 72.0, 12436, 773, 646, 5.0, 62180),
    ("NeuraLUT", 72.0, 4684, 341, 727, 3.0, 14148),
    ("PolyLUT-Add", 72.0, 895, 189, 750, 4.0, 3580),
    ("LLNN", 72.0, 6431, 0, 449, 2.2, 14148),
    ("DWN-PEN+FT (sm-10) (6-Bit)", 71.2, 64, 18, 1307, 1.6, 102),
    ("AmigoLUT-NeuraLUT-XS", 71.1, 320, 482, 1445, 3.5, 1120),
]

#: paper accuracy baselines (§III)
PAPER_BASELINES = {"sm-10": 71.1, "sm-50": 74.0, "md-360": 75.6,
                   "lg-2400": 76.3}


@dataclasses.dataclass
class ComparisonRow:
    model: str
    variant: str
    ours: HWReport
    paper_luts: int | None = None

    @property
    def lut_error_pct(self) -> float | None:
        if not self.paper_luts:
            return None
        return 100.0 * (self.ours.total_luts - self.paper_luts) / self.paper_luts


def compare_with_paper(frozen, *, model_name: str, variant: str,
                       input_bits: int | None = None) -> ComparisonRow:
    rep = dwn_hw_report(frozen, variant=variant, name=model_name,
                        input_bits=input_bits)
    paper = None
    if variant == "TEN":
        paper = PAPER_TABLE3.get(model_name, {}).get("ten_luts")
    elif variant == "PEN":
        paper = PAPER_TABLE3.get(model_name, {}).get("pen_luts")
    else:
        paper = PAPER_TABLE3.get(model_name, {}).get("ft_luts")
    return ComparisonRow(model_name, variant, rep, paper)


__all__ = [
    "ComparisonRow", "PAPER_BASELINES", "PAPER_TABLE1", "PAPER_TABLE2",
    "PAPER_TABLE3", "compare_with_paper",
]
