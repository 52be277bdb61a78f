"""Design-space grids: which encoding points a sweep visits.

The port's copy of the reference's ``repro.sweep.grid``: the same points,
labels and dict form, so a grid file or a sweep JSON names the same points
in both packages.

A *grid point* fixes everything the paper shows can dominate DWN hardware
cost: the JSC preset (LUT-layer width m), the encoding variant (TEN — the
accelerator receives thermometer bits; PEN — it receives fixed-point
features and encodes on chip), the encoder resolution (thermometer bits
per feature T), the threshold placement (distributive / uniform /
gaussian), and — for PEN — the input bit-width the on-chip comparators
see.  ``repro_torch.sweep.pipeline`` runs every point through one shared
pipeline (accuracy x FPGA cost x kernel/serving throughput).

Named grids:

* ``tiny``     — 2 presets x {TEN, PEN@4b, PEN@9b}: the CI smoke and the
                 monotonicity test bed (6 points, seconds on CPU).
* ``paper``    — the 4 paper presets x {TEN, PEN at Table I's fine-tuned
                 bit-widths}: regenerates the Table I TEN LUT counts
                 (checked against tolerances in docs/reproduction.md).
* ``encoding`` — sm-50 x 3 placements x T in {50, 100, 200} at PEN 9-bit:
                 the encoding-cost curve (Fig. 2's axis, extended).

Custom grids load from a JSON list of point dicts (see ``load_grid``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

#: encoding variants a sweep point may take (PEN+FT is a training recipe,
#: not a datapath — the sweep treats fine-tuned models as PEN points).
VARIANTS = ("TEN", "PEN")

#: Table I's fine-tuned input bit-widths (total width, sign included) —
#: the PEN operating points the paper grid visits per preset.
PAPER_FT_BITS = {"sm-10": 6, "sm-50": 8, "md-360": 9, "lg-2400": 9}


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One point of the encoding design space.

    Attributes:
      preset: workload tier (JSC: "sm-10" | "sm-50" | "md-360" |
        "lg-2400"; MNIST: "mnist-{sm,md,lg}") — fixes the LUT-layer
        width m.
      variant: "TEN" (off-chip encoding, bits arrive pre-encoded) or
        "PEN" (on-chip encoder at ``input_bits``).
      bits: thermometer bits per feature T (encoder resolution).
      placement: threshold placement mode ("distributive" | "uniform" |
        "gaussian").
      input_bits: PEN input width in total bits (1 sign + n fractional);
        None for TEN.
      workload: registered workload name the point trains/evaluates on
        (default "jsc"; see ``repro_torch.workloads``).
    """

    preset: str
    variant: str = "TEN"
    bits: int = 200
    placement: str = "distributive"
    input_bits: int | None = None
    workload: str = "jsc"

    def __post_init__(self):
        assert self.variant in VARIANTS, self.variant
        assert (self.input_bits is None) == (self.variant == "TEN"), self

    @property
    def frac_bits(self) -> int | None:
        """Fractional bits of the (1, n) fixed-point grid; None for TEN."""
        return None if self.input_bits is None else self.input_bits - 1

    @property
    def label(self) -> str:
        b = "" if self.input_bits is None else f"@{self.input_bits}b"
        wl = "" if self.workload == "jsc" else f"{self.workload}:"
        return (f"{wl}{self.preset}/{self.variant}{b}/T{self.bits}/"
                f"{self.placement}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # the default workload is omitted so pre-workload cache keys and
        # saved grid/result JSON stay valid
        if d["workload"] == "jsc":
            del d["workload"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SweepPoint":
        return cls(**d)


def tiny_grid() -> list[SweepPoint]:
    """2 presets x {TEN, PEN@4b, PEN@9b} — the smoke/test grid."""
    pts = []
    for preset in ("sm-10", "sm-50"):
        pts.append(SweepPoint(preset, "TEN"))
        for ib in (4, 9):
            pts.append(SweepPoint(preset, "PEN", input_bits=ib))
    return pts


def paper_grid() -> list[SweepPoint]:
    """4 presets x {TEN, PEN at Table I's fine-tuned widths}."""
    pts = []
    for preset in ("sm-10", "sm-50", "md-360", "lg-2400"):
        pts.append(SweepPoint(preset, "TEN"))
        pts.append(SweepPoint(preset, "PEN",
                              input_bits=PAPER_FT_BITS[preset]))
    return pts


def encoding_grid() -> list[SweepPoint]:
    """sm-50 x 3 placements x T in {50, 100, 200} at PEN 9-bit."""
    pts = []
    for placement in ("distributive", "uniform", "gaussian"):
        for T in (50, 100, 200):
            pts.append(SweepPoint("sm-50", "PEN", bits=T,
                                  placement=placement, input_bits=9))
    return pts


def mnist_tiny_grid() -> list[SweepPoint]:
    """mnist-sm x {TEN, PEN@5b, PEN@8b} + mnist-md TEN — the MNIST CI
    smoke grid (synthetic fallback; seconds on CPU at small T)."""
    pts = [SweepPoint("mnist-sm", "TEN", bits=8, workload="mnist")]
    for ib in (5, 8):
        pts.append(SweepPoint("mnist-sm", "PEN", bits=8, input_bits=ib,
                              workload="mnist"))
    pts.append(SweepPoint("mnist-md", "TEN", bits=8, workload="mnist"))
    return pts


def mnist_grid() -> list[SweepPoint]:
    """{sm,md,lg} x {TEN, PEN@5b, PEN@8b} — the encoding-LUT-share
    analysis on the second dataset (sm/md at T=8, lg at T=16)."""
    pts = []
    for preset, T in (("mnist-sm", 8), ("mnist-md", 8), ("mnist-lg", 16)):
        pts.append(SweepPoint(preset, "TEN", bits=T, workload="mnist"))
        for ib in (5, 8):
            pts.append(SweepPoint(preset, "PEN", bits=T, input_bits=ib,
                                  workload="mnist"))
    return pts


GRIDS = {"tiny": tiny_grid, "paper": paper_grid, "encoding": encoding_grid,
         "mnist-tiny": mnist_tiny_grid, "mnist": mnist_grid}


def load_grid(name_or_path: str) -> list[SweepPoint]:
    """Resolve a grid: a named grid or a JSON file of point dicts.

    Args:
      name_or_path: one of ``GRIDS`` or a path to a JSON list, e.g.
        ``[{"preset": "sm-50", "variant": "PEN", "input_bits": 8}, ...]``.

    Returns the list of :class:`SweepPoint`.
    """
    if name_or_path in GRIDS:
        return GRIDS[name_or_path]()
    path = Path(name_or_path)
    if not path.exists():
        raise ValueError(f"unknown grid {name_or_path!r}: not a named grid "
                         f"({sorted(GRIDS)}) and no such file")
    with open(path) as fh:
        return [SweepPoint.from_dict(d) for d in json.load(fh)]


__all__ = ["GRIDS", "PAPER_FT_BITS", "SweepPoint", "VARIANTS",
           "encoding_grid", "load_grid", "mnist_grid", "mnist_tiny_grid",
           "paper_grid", "tiny_grid"]
