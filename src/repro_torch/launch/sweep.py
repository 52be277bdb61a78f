"""Sweep CLI: a thin argparse front-end over ``repro_torch.sweep``.

The port's counterpart of ``repro.launch.sweep``, flag for flag, plus
``--device`` (default ``cuda``: it raises without a card unless
``--device cpu``).  Runs an encoding design-space grid through the shared
pipeline (accuracy x FPGA cost x K2 kernel time x served throughput),
prints the result table + Pareto fronts, checks any paper-referenced
points against their documented tolerances, and writes everything as one
JSON artifact.  Its cache root defaults to ``results/sweep_cache_torch``,
apart from the reference's.

Usage:
    python -m repro_torch.launch.sweep --grid tiny --out sweep.json
    python -m repro_torch.launch.sweep --grid paper --out sweep.json --plots
    python -m repro_torch.launch.sweep --grid encoding --epochs 2 --no-serve
    python -m repro_torch.launch.sweep --grid my_points.json --fresh
    python -m repro_torch.launch.sweep --grid encoding --autodesign \
        --acc-floor 0.70
    python -m repro_torch.launch.sweep --grid paper --workers 4 \
        --artifact-dir results/sweep_artifacts
    python -m repro_torch.launch.sweep --grid tiny --device cpu --no-kernel \
        --no-serve

``--workers N`` switches to the resilient parallel executor
(``repro_torch.sweep.executor``): grid points shard across N worker
processes, each point runs under a bounded restart policy, completed
points commit to the cache atomically (a killed run resumes with zero
recomputed points), straggler points are speculatively re-dispatched, and
SIGTERM drains gracefully (exit 0, resumable).  ``--chaos kill-after-N``
injects worker deaths for testing.  On one card every worker shares it,
so the kernel and serve columns of a parallel run are shared-card
numbers.

``--autodesign`` walks the accuracy-vs-LUTs Pareto front (min LUTs at an
accuracy floor, or max accuracy under ``--lut-budget``), rebuilds the
winner, co-simulates its emitted Verilog against the packed oracle
(``repro_torch.hw.cosim``), and writes the verified RTL — non-zero exit
on any mismatch or unmet objective.
"""

from __future__ import annotations

import argparse
import math
import sys

from ..device import resolve_device
from ..sweep import SweepSettings, run_grid
from ..sweep.artifacts import TABLE1_TEN_TOLERANCE
from ..sweep.pipeline import DEFAULT_CACHE_DIR


def ascii_scatter(points, *, x_of, y_of, mark_of=lambda p: "*",
                  y_lo: float, y_hi: float, y_step: float,
                  x_label: str, log_x: bool = True, width: int = 70):
    """Print a log-x ASCII scatter (the repo's house plot style)."""
    xs = [x_of(p) for p in points if y_of(p) is not None]
    if not xs:
        print("  (no points with this axis measured)")
        return
    x_min = min(xs)
    x_max = max(x_min + 1, max(xs))

    def col(x):
        if log_x:
            span = math.log10(max(x_max, 10)) - math.log10(max(x_min, 1))
            f = ((math.log10(max(x, 1)) - math.log10(max(x_min, 1)))
                 / max(span, 1e-9))
        else:
            f = (x - x_min) / max(x_max - x_min, 1e-9)
        return min(int(f * (width - 1)), width - 1)

    y = y_hi
    while y > y_lo:
        line = [" "] * width
        for p in points:
            v = y_of(p)
            if v is not None and y - y_step <= v < y:
                line[col(x_of(p))] = mark_of(p)
        print(f"{y - y_step:8.1f} |" + "".join(line))
        y -= y_step
    print(" " * 9 + "-" * width)
    print(" " * 9 + x_label)


def check_paper_points(result) -> list[str]:
    """Tolerance check of every paper-referenced TEN point.

    Returns a list of failure strings (empty = all TEN references are
    within the documented tolerance, ``TABLE1_TEN_TOLERANCE``).
    """
    failures = []
    for r in result.points:
        if r.paper_luts is None or r.point.variant != "TEN":
            continue
        tol = TABLE1_TEN_TOLERANCE.get(r.point.preset)
        if tol is None:
            continue
        err = abs(r.total_luts - r.paper_luts) / r.paper_luts
        status = "ok" if err <= tol else "FAIL"
        print(f"  Table I TEN {r.point.preset}: ours={r.total_luts} "
              f"paper={r.paper_luts} err={100 * err:.1f}% "
              f"(tol {100 * tol:.0f}%) {status}")
        if err > tol:
            failures.append(f"{r.point.preset}: {100 * err:.1f}% "
                            f"> {100 * tol:.0f}%")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", default="tiny",
                    help="named grid (tiny|paper|encoding|mnist-tiny|"
                         "mnist) or a JSON file of point dicts")
    ap.add_argument("--out", default="",
                    help="write the SweepResult JSON here")
    ap.add_argument("--plots", action="store_true",
                    help="print ASCII Pareto plots (acc vs LUTs, "
                         "throughput vs LUTs)")
    ap.add_argument("--epochs", type=int, default=0,
                    help="training epochs per model (0 = warmstart only; "
                         "hardware axes don't need training)")
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-test", type=int, default=2000)
    ap.add_argument("--no-accuracy", action="store_true",
                    help="skip the packed hard-accuracy pass")
    ap.add_argument("--no-kernel", action="store_true",
                    help="skip fused-kernel timing")
    ap.add_argument("--serve", dest="serve", action="store_true",
                    default=True, help="time the serving engine (default)")
    ap.add_argument("--no-serve", dest="serve", action="store_false")
    ap.add_argument("--serve-backend", default="fused-packed")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                    help="incremental result cache ('' disables)")
    ap.add_argument("--fresh", action="store_true",
                    help="recompute every point (cache is still refreshed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes for the resilient parallel "
                         "executor (0 = serial in-process, -1 = auto)")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="per-point failure budget (worker deaths + "
                         "in-worker retries) before the point is "
                         "reported failed")
    ap.add_argument("--artifact-dir", default="",
                    help="checkpoint every computed point's packed "
                         "DWNArtifact here (runtime.checkpoint."
                         "save_artifact; '' disables)")
    ap.add_argument("--no-speculate", action="store_true",
                    help="disable straggler speculative re-dispatch")
    ap.add_argument("--chaos", default="",
                    help="fault injection: kill-after-N | raise-after-N | "
                         "raise-always | stall-I:S (testing only)")
    ap.add_argument("--autodesign", action="store_true",
                    help="pick a design from the accuracy-vs-LUTs Pareto "
                         "front and emit its co-simulation-verified "
                         "Verilog (needs --acc-floor or --lut-budget)")
    ap.add_argument("--acc-floor", type=float, default=None,
                    help="autodesign objective: minimum LUTs subject to "
                         "accuracy >= FLOOR")
    ap.add_argument("--lut-budget", type=int, default=None,
                    help="autodesign objective: maximum accuracy subject "
                         "to total LUTs <= BUDGET")
    ap.add_argument("--autodesign-out", default="results/autodesign",
                    help="directory for the verified RTL + summary JSON")
    ap.add_argument("--cosim-n", type=int, default=256,
                    help="workload test vectors for the RTL verification")
    ap.add_argument("--cosim-backend", default="auto",
                    choices=["auto", "python", "iverilog"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every axis runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)                # no card: raise, never fall back

    settings = SweepSettings(
        n_train=args.n_train, n_test=args.n_test, seed=args.seed,
        train_epochs=args.epochs, accuracy=not args.no_accuracy,
        kernel=not args.no_kernel, serve=args.serve,
        serve_backend=args.serve_backend, device=args.device)
    log = lambda m: print(m, flush=True)                      # noqa: E731
    if args.workers:
        from ..sweep.executor import ExecutorSettings, run_grid_parallel
        ex = ExecutorSettings(
            workers=None if args.workers < 0 else args.workers,
            max_restarts=args.max_restarts,
            speculate=not args.no_speculate,
            artifact_dir=args.artifact_dir or None,
            chaos=args.chaos or None)
        result = run_grid_parallel(args.grid, settings,
                                   cache_dir=args.cache_dir or None,
                                   fresh=args.fresh, executor=ex, log=log)
    else:
        result = run_grid(args.grid, settings,
                          cache_dir=args.cache_dir or None,
                          fresh=args.fresh, log=log,
                          artifact_dir=args.artifact_dir or None)

    print()
    print(result.table())
    exb = result.executor or {}
    if exb:
        print(f"\nexecutor: mode={exb.get('mode')} "
              f"computed={exb.get('computed')} "
              f"cache_hits={exb.get('cache_hits')} "
              f"failed={len(exb.get('failed', []))} "
              f"restarts={exb.get('restarts')} "
              f"stragglers={exb.get('stragglers_redispatched')} "
              f"wall={exb.get('wall_s')}s")
    if exb.get("interrupted"):
        print(f"PREEMPTED: {exb.get('remaining')} point(s) not run; "
              f"completed work is cached — re-run the same command to "
              f"resume with zero recomputed points")
        if args.out:
            result.save(args.out)
            print(f"written partial {args.out}")
        return 0

    shares = [r for r in result.points
              if not r.failed and r.encoder_share is not None]
    if shares:
        # the paper's core finding, reported per grid: how much of the
        # total LUT cost the thermometer encoder is (PEN pays it
        # on-chip; TEN's encoder share is 0 by construction)
        print("\nencoder LUT share (encoder / total):")
        for r in sorted(shares, key=lambda r: -r.encoder_share)[:8]:
            enc = r.luts.get("encoder", 0)
            rest = max(r.total_luts - enc, 1)
            print(f"  {100 * r.encoder_share:5.1f}%  ({enc} of "
                  f"{r.total_luts} LUTs, {enc / rest:.2f}x the rest)  "
                  f"{r.point.label}")

    front_a = result.accuracy_vs_luts_front()
    if front_a:
        print("\nPareto front (accuracy vs LUTs):")
        for r in front_a:
            print(f"  {r.total_luts:>8d} LUT  acc={r.accuracy:.3f}  "
                  f"{r.point.label}")
    front_t = result.throughput_vs_luts_front()
    if front_t:
        print("\nPareto front (serving throughput vs LUTs):")
        for r in front_t:
            print(f"  {r.total_luts:>8d} LUT  {r.serve_throughput:>9.0f} "
                  f"samples/s  {r.point.label}")

    print("\nPaper reference check:")
    failures = check_paper_points(result)
    refs = [r for r in result.points if r.paper_luts is not None]
    if not refs:
        print("  (no paper-referenced points in this grid)")

    if args.plots:
        accs = [r.accuracy for r in result.points
                if r.accuracy is not None]
        if accs:
            print("\naccuracy vs log10(LUTs):  T=TEN  P=PEN")
            lo = math.floor(min(accs) * 20) / 20
            hi = math.ceil(max(accs) * 20) / 20 + 0.05
            ascii_scatter(result.points, x_of=lambda r: r.total_luts,
                          y_of=lambda r: r.accuracy,
                          mark_of=lambda r: r.point.variant[0],
                          y_lo=lo, y_hi=hi, y_step=0.05,
                          x_label="LUTs (log scale)")
        if any(r.serve_throughput is not None for r in result.points):
            thr = [r.serve_throughput for r in result.points
                   if r.serve_throughput is not None]
            step = max(max(thr) / 10, 1.0)
            print("\nserving samples/s vs log10(LUTs):")
            ascii_scatter(result.points, x_of=lambda r: r.total_luts,
                          y_of=lambda r: r.serve_throughput,
                          mark_of=lambda r: r.point.variant[0],
                          y_lo=0.0, y_hi=max(thr) + step, y_step=step,
                          x_label="LUTs (log scale)")

    if args.out:
        result.save(args.out)
        cached = sum(r.cached for r in result.points)
        print(f"\nwritten {args.out}: {len(result.points)} points "
              f"({cached} from cache)")

    if args.autodesign:
        from ..hw.cosim import RTLMismatch
        from ..sweep.autodesign import (AutodesignError, choose_design,
                                        emit_verified)
        print("\nAutodesign:")
        try:
            choice = choose_design(result, acc_floor=args.acc_floor,
                                   lut_budget=args.lut_budget)
            emit_verified(choice, settings, out_dir=args.autodesign_out,
                          n_vectors=args.cosim_n,
                          backend=args.cosim_backend,
                          log=lambda m: print(f"  {m}", flush=True))
        except AutodesignError as e:
            print(f"  autodesign FAILED: {e}")
            return 1
        except RTLMismatch as e:
            print(f"  autodesign RTL VERIFICATION FAILED:\n{e}")
            return 1

    if failures:
        print(f"\npaper-tolerance FAILURES: {failures}")
        return 1
    failed_pts = [r.point.label for r in result.points if r.failed]
    if failed_pts:
        # the grid completed around them (no abort), but a failed point
        # is still a failed run for CI purposes
        print(f"\nFAILED points (restart budget exhausted): {failed_pts}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
