"""Encoding-aware autodesign: Pareto front -> chosen spec -> verified RTL.

The port's copy of the reference's ``repro.sweep.autodesign``.  One
difference: :func:`emit_verified` co-simulates on the chosen point's own
workload (the reference reads the JSC split for every point, so an MNIST
point fails there in broadcasting).

Automates the paper's core finding as a search.  Thermometer encoding
can be up to 3.20x of DWN LUT cost, so the cheapest design meeting an
accuracy target is an *encoding* choice as much as an architecture
choice.  A completed sweep already measured accuracy and LUTs at every
grid point; :func:`choose_design` walks the accuracy-vs-LUTs Pareto
frontier to pick

* the **minimum-LUT** point with ``accuracy >= acc_floor``, or
* the **maximum-accuracy** point with ``total_luts <= lut_budget``,

and :func:`emit_verified` rebuilds that point's artifact deterministically
(same memoized path the sweep used), co-simulates the emitted Verilog
against the packed oracle (``hw.cosim.verify_rtl`` — bit-exact on the
point's workload vectors, raising ``RTLMismatch`` on any disagreement),
and writes the *verified* RTL plus a JSON summary.  One command end to
end::

    python -m repro_torch.launch.sweep --grid encoding --autodesign \
        --acc-floor 0.70
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from .pipeline import SweepRunner, SweepSettings
from .results import SweepResult


class AutodesignError(ValueError):
    """No sweep point satisfies the requested objective."""


@dataclasses.dataclass
class AutodesignChoice:
    """A selected design point plus the objective that selected it."""

    result: object                # the winning PointResult
    objective: str                # "min-luts@acc>=X" | "max-acc@luts<=N"
    acc_floor: float | None = None
    lut_budget: int | None = None
    front_size: int = 0
    candidates: int = 0

    @property
    def point(self):
        return self.result.point

    def to_dict(self) -> dict:
        return {"objective": self.objective,
                "acc_floor": self.acc_floor,
                "lut_budget": self.lut_budget,
                "front_size": self.front_size,
                "candidates": self.candidates,
                "chosen": self.result.to_dict()}


def choose_design(result: SweepResult, *, acc_floor: float | None = None,
                  lut_budget: int | None = None) -> AutodesignChoice:
    """Pick a design from a completed sweep's Pareto frontier.

    Exactly one of ``acc_floor`` / ``lut_budget`` must be given.  The
    accuracy-vs-LUTs front is sorted by ascending LUT cost with strictly
    increasing accuracy, so the first front point clearing the floor IS
    the minimum-LUT qualifying design, and the last front point under
    the budget IS the maximum-accuracy affordable one.

    Raises :class:`AutodesignError` when nothing qualifies (no silent
    fallback — an unmet floor must fail the command).
    """
    if (acc_floor is None) == (lut_budget is None):
        raise AutodesignError(
            "choose_design needs exactly one objective: acc_floor "
            "(min LUTs at an accuracy floor) or lut_budget "
            "(max accuracy under a LUT budget)")
    front = [r for r in result.accuracy_vs_luts_front()
             if r.accuracy is not None]
    if not front:
        raise AutodesignError(
            "sweep has no accuracy measurements (ran with --no-accuracy?) "
            "— autodesign needs the accuracy-vs-LUTs front")
    if acc_floor is not None:
        for r in front:
            if r.accuracy >= acc_floor:
                return AutodesignChoice(
                    result=r, objective=f"min-luts@acc>={acc_floor}",
                    acc_floor=acc_floor, front_size=len(front),
                    candidates=len(result.points))
        best = max(front, key=lambda r: r.accuracy)
        raise AutodesignError(
            f"no sweep point reaches accuracy {acc_floor:.4f}; best on "
            f"the front is {best.accuracy:.4f} ({best.point.label}, "
            f"{best.total_luts} LUTs)")
    chosen = None
    for r in front:
        if r.total_luts <= lut_budget:
            chosen = r                      # front ascends in both axes
    if chosen is None:
        cheapest = front[0]
        raise AutodesignError(
            f"no sweep point fits the {lut_budget}-LUT budget; cheapest "
            f"on the front is {cheapest.total_luts} LUTs "
            f"({cheapest.point.label})")
    return AutodesignChoice(
        result=chosen, objective=f"max-acc@luts<={lut_budget}",
        lut_budget=lut_budget, front_size=len(front),
        candidates=len(result.points))


def emit_verified(choice: AutodesignChoice,
                  settings: SweepSettings | None = None, *,
                  out_dir, n_vectors: int = 256, backend: str = "auto",
                  pipeline: bool = True, log=print) -> dict:
    """Rebuild the chosen point, co-simulate its RTL, write the artifacts.

    The artifact is rebuilt through ``SweepRunner.artifact_for`` — the
    same deterministic memoized path the sweep measured — and packed on
    ``settings.device``, then ``verify_rtl`` proves the emitted netlist
    bit-exact against ``apply_hard_packed`` (run there) on ``n_vectors``
    held-out test vectors of the point's workload.  Any
    disagreement raises ``hw.cosim.RTLMismatch`` (the CLI turns that
    into a non-zero exit); nothing is written for an unverified design
    except the exception itself.

    Writes ``dwn_autodesign.v`` (the verified RTL) and
    ``autodesign.json`` (choice + verification report) into ``out_dir``;
    returns the summary dict.
    """
    runner = SweepRunner(settings or SweepSettings())
    art = runner.artifact_for(choice.point).pack(runner.device)
    x = runner.data_for(choice.point.workload).x_test[:n_vectors]
    report = art.verify_rtl(x, backend=backend, pipeline=pipeline,
                            name="dwn_autodesign")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rtl_path = out / "dwn_autodesign.v"
    rtl_path.write_text(report.src)
    summary = {"choice": choice.to_dict(),
               "spec": art.spec.to_dict(),
               "spec_label": art.spec.label,
               "verification": report.to_dict(),
               "rtl": rtl_path.name}
    (out / "autodesign.json").write_text(json.dumps(summary, indent=1))
    if log:
        log(f"autodesign: {choice.objective} -> {choice.point.label} "
            f"({choice.result.total_luts} LUTs, "
            f"acc={choice.result.accuracy:.4f})")
        log(f"autodesign: RTL verified bit-exact on {report.n_vectors} "
            f"vectors ({'+'.join(report.backends)}) -> {rtl_path}")
    return summary


__all__ = ["AutodesignChoice", "AutodesignError", "choose_design",
           "emit_verified"]
