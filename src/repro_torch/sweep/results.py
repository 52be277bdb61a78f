"""Sweep result containers: one table, Pareto fronts, JSON round-trip.

The port's copy of the reference's ``repro.sweep.results``.  The JSON
schema is the reference's, so either package loads a sweep JSON the other
wrote.

A sweep emits one :class:`SweepResult` holding a :class:`PointResult` per
grid point.  Each row carries all three co-design axes —

* **accuracy** — hard-inference accuracy through ``apply_hard_packed``
  (fraction in [0, 1]; None when the point ran without an accuracy pass);
* **FPGA cost** — the ``hw.cost.dwn_hw_report`` breakdown: LUT counts per
  component (encoder / lut_layer / popcount / argmax), FFs, estimated
  combinational delay in **ns** and pipelined Fmax in **MHz**;
* **throughput** — fused packed-kernel (K2) wall time per batch in **µs**
  and serving-engine throughput in **samples/s** (None when those axes
  were skipped).  On a card they are that card's numbers; a parallel run
  on one card shares it between its workers.

plus the paper's reference LUT count and % error where the point lands on
a published Table I/III row.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Sequence

from .grid import SweepPoint

#: the fields of a row that depend only on the point and the settings'
#: seed and splits (the FPGA cost and the accuracy): two runs of a point
#: agree on them exactly, on any device and in any worker, where the
#: kernel and serve axes are timings
EXACT_FIELDS = ("luts", "total_luts", "total_ffs", "delay_ns", "fmax_mhz",
                "distinct_comparators", "paper_luts", "lut_error_pct",
                "encoder_share", "accuracy")


@dataclasses.dataclass
class PointResult:
    """Everything measured at one grid point (see module docstring for
    units).  ``cached`` marks rows served from the sweep cache."""

    point: SweepPoint
    accuracy: float | None = None
    luts: dict = dataclasses.field(default_factory=dict)  # component -> LUTs
    total_luts: int = 0
    total_ffs: int = 0
    delay_ns: float = 0.0
    fmax_mhz: float = 0.0
    distinct_comparators: int = 0
    paper_luts: int | None = None
    lut_error_pct: float | None = None
    encoder_share: float | None = None        # encoder LUTs / total LUTs
    kernel_us: float | None = None            # fused packed kernel, per batch
    kernel_batch: int | None = None
    serve_throughput: float | None = None     # samples/s through the engine
    serve_p50_ms: float | None = None         # compute latency per microbatch
    serve_backend: str | None = None
    cached: bool = False
    failed: bool = False                      # executor gave up on this point
    error: str | None = None                  # last failure (when failed)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["point"] = self.point.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PointResult":
        d = dict(d)
        d["point"] = SweepPoint.from_dict(d["point"])
        return cls(**d)


def pareto_front(items: Sequence, cost: Callable, score: Callable) -> list:
    """Generic Pareto frontier: minimize ``cost``, maximize ``score``.

    Walks items in ascending cost and keeps each one that strictly improves
    the best score seen so far — the classic staircase frontier.  Items
    whose score is None are skipped.  This is the exact frontier rule the
    Fig. 6 benchmark has always used; it lives here so every consumer
    (benchmarks, the sweep CLI, tests) shares one definition.
    """
    front = []
    for it in sorted(items, key=cost):
        s = score(it)
        if s is None:
            continue
        if not front or s > score(front[-1]):
            front.append(it)
    return front


@dataclasses.dataclass
class SweepResult:
    """A completed sweep: grid + settings provenance + per-point rows.

    ``executor`` carries the run's execution provenance (serial or
    parallel): worker count, computed vs cache-hit point counts, failed
    points, straggler re-dispatches, restart count, and whether the run
    was preempted mid-grid — the counters the chaos-resume CI smoke
    asserts on.
    """

    grid: str
    settings: dict
    points: list
    executor: dict | None = None

    # -- views ---------------------------------------------------------

    def accuracy_vs_luts_front(self) -> list:
        """Pareto frontier maximizing accuracy, minimizing total LUTs."""
        return pareto_front(self.points, cost=lambda r: r.total_luts,
                            score=lambda r: r.accuracy)

    def throughput_vs_luts_front(self) -> list:
        """Pareto frontier maximizing serving throughput vs LUTs."""
        return pareto_front(self.points, cost=lambda r: r.total_luts,
                            score=lambda r: r.serve_throughput)

    def table(self) -> str:
        """Markdown table over every point (the sweep's printed artifact)."""
        head = ("| point | acc | LUT total | enc | enc% | lut | pop | argmax "
                "| paper | err% | kernel µs | serve/s |\n"
                "|---|---|---|---|---|---|---|---|---|---|---|---|")
        rows = []
        for r in self.points:
            if r.failed:
                rows.append(f"| {r.point.label} | FAILED ({r.error}) "
                            + "| - " * 10 + "|")
                continue
            acc = f"{r.accuracy:.3f}" if r.accuracy is not None else "-"
            err = (f"{r.lut_error_pct:+.1f}"
                   if r.lut_error_pct is not None else "-")
            ker = f"{r.kernel_us:.0f}" if r.kernel_us is not None else "-"
            srv = (f"{r.serve_throughput:.0f}"
                   if r.serve_throughput is not None else "-")
            share = (f"{100 * r.encoder_share:.1f}"
                     if r.encoder_share is not None else "-")
            rows.append(
                f"| {r.point.label} | {acc} | {r.total_luts} "
                f"| {r.luts.get('encoder', 0)} | {share} "
                f"| {r.luts.get('lut_layer', 0)} "
                f"| {r.luts.get('popcount', 0)} | {r.luts.get('argmax', 0)} "
                f"| {r.paper_luts or '-'} | {err} | {ker} | {srv} |")
        return "\n".join([head] + rows)

    # -- (de)serialization ---------------------------------------------

    def to_dict(self) -> dict:
        out = {"grid": self.grid, "settings": self.settings,
               "points": [r.to_dict() for r in self.points],
               "pareto": {
                   "accuracy_vs_luts":
                       [r.point.label for r in self.accuracy_vs_luts_front()],
                   "throughput_vs_luts":
                       [r.point.label
                        for r in self.throughput_vs_luts_front()],
               }}
        if self.executor is not None:
            out["executor"] = self.executor
        return out

    def save(self, path: str | Path) -> None:
        """Write the sweep (points + frontiers) as one JSON artifact."""
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1)

    @classmethod
    def load(cls, path: str | Path) -> "SweepResult":
        with open(path) as fh:
            d = json.load(fh)
        return cls(grid=d["grid"], settings=d["settings"],
                   points=[PointResult.from_dict(p) for p in d["points"]],
                   executor=d.get("executor"))


__all__ = ["PointResult", "SweepResult", "pareto_front"]
