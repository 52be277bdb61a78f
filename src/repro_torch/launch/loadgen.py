"""Open-loop load generator for the DWN serving engine.

The port's own copy of the reference's ``repro.launch.loadgen``: the same
schedules bit for bit, the same metrics, driving the port's
``ServingEngine`` (on the CUDA card unless ``--device cpu``).

Closed-loop benchmarks (submit a fixed stream, drain, divide) measure a
*point*; they cannot say what the engine sustains when traffic does not
wait for it.  This module generates **open-loop** traffic — arrivals
follow a seeded Poisson process whose timeline never reacts to engine
latency — and drives either serving mode with it:

* ``run_async``: the continuous-batching path (``submit_async`` with
  per-tenant deadlines/priorities; ``QueueFull`` rejections count as
  shed — backpressure is part of the operating envelope);
* ``run_sync``: the synchronous submit/drain facade, the baseline the
  latency–throughput curve is compared against.  Arrivals falling due
  while ``drain()`` blocks are submitted when it returns, but their
  latency is still measured **from the intended arrival time** — the
  standard correction for coordinated omission, applied identically in
  both modes.

Traffic shape: exponential inter-arrivals at ``rate_rps``, optionally
multiplied by ``burst_factor`` inside periodic burst windows; per-arrival
size/deadline/priority drawn from a weighted multi-tenant mix (tenants
can also target different presets — the harness routes each to its own
engine).  Everything is derived from one ``numpy`` generator seeded by
``LoadSpec.seed``, so a schedule is reproducible bit-for-bit.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.loadgen --preset dwn-jsc-lg \\
        --max-bucket 4096 --levels 0.5,1.0,1.3 --duration 2 --mode both \\
        --out curve.json

Prints one JSON line per level.  ``--device`` (default ``cuda``, never
falling back) and ``--slo-queue-samples`` (``SLOConfig.max_queue_samples``,
the bound on queued samples; the default holds one request at
``--max-bucket 4096``) are the port's own flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from ..serving.continuous import QueueFull, SLOConfig
from ..serving.scheduler import percentiles


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One traffic class in the mix.

    ``size`` is a distribution spec: ``"fixed:N"`` or ``"uniform:LO:HI"``
    (inclusive).  ``preset`` routes the tenant to a named engine (None =
    the single default engine).  ``deadline_ms`` / ``priority`` are
    forwarded to ``submit_async`` (the sync baseline ignores both — it
    has no admission control, which is the point of the comparison).
    """

    name: str = "default"
    weight: float = 1.0
    size: str = "uniform:32:256"
    deadline_ms: float | None = None
    priority: int = 0
    preset: str | None = None

    def sample_size(self, rng: np.random.Generator) -> int:
        kind, *args = self.size.split(":")
        if kind == "fixed":
            return int(args[0])
        if kind == "uniform":
            lo, hi = int(args[0]), int(args[1])
            return int(rng.integers(lo, hi + 1))
        raise ValueError(f"unknown size distribution {self.size!r}")


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One offered-load level: a Poisson arrival process over a tenant
    mix, optionally burstier inside periodic windows."""

    rate_rps: float
    duration_s: float
    seed: int = 0
    #: rate multiplier inside bursts (1.0 = stationary Poisson)
    burst_factor: float = 1.0
    burst_every_s: float = 0.0      # burst window period (0 = no bursts)
    burst_len_s: float = 0.0        # burst window length
    tenants: tuple[Tenant, ...] = (Tenant(),)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: when, how big, for whom."""

    t: float                        # seconds after stream start
    size: int
    tenant: str
    deadline_ms: float | None
    priority: int
    preset: str | None


def make_arrivals(spec: LoadSpec) -> list[Arrival]:
    """The deterministic open-loop schedule for one load level.

    Thinning-free piecewise-Poisson: inter-arrival gaps are exponential
    at the instantaneous rate (base, or base*burst_factor inside a burst
    window).  Same ``LoadSpec`` -> identical schedule, always.
    """
    rng = np.random.default_rng(spec.seed)
    weights = np.asarray([t.weight for t in spec.tenants], np.float64)
    weights = weights / weights.sum()
    out: list[Arrival] = []
    t = 0.0
    while True:
        in_burst = (spec.burst_every_s > 0
                    and (t % spec.burst_every_s) < spec.burst_len_s)
        rate = spec.rate_rps * (spec.burst_factor if in_burst else 1.0)
        t += float(rng.exponential(1.0 / rate))
        if t >= spec.duration_s:
            return out
        tenant = spec.tenants[int(rng.choice(len(spec.tenants), p=weights))]
        out.append(Arrival(t=t, size=tenant.sample_size(rng),
                           tenant=tenant.name,
                           deadline_ms=tenant.deadline_ms,
                           priority=tenant.priority, preset=tenant.preset))


def _engine_for(engines, arrival: Arrival):
    if arrival.preset is None:
        assert len(engines) == 1, \
            "tenant without preset needs a single-engine run"
        return next(iter(engines.values()))
    return engines[arrival.preset]


def _sleep_until(t_abs: float) -> None:
    # plain sleep only: it releases the GIL, which the scheduler thread
    # needs (a spin-wait here measurably starves the step loop).  Sleep
    # granularity (~0.1-1ms) just shifts submits late; the lateness is
    # recorded per arrival and latency is measured from the intended
    # time, so the timeline stays honest
    dt = t_abs - time.perf_counter()
    if dt > 0:
        time.sleep(dt)


def run_async(engines: dict, arrivals: list[Arrival], payloads: list, *,
              slo: SLOConfig | None = None,
              submit_timeout_s: float = 0.0) -> dict:
    """Drive the continuous-batching path with one open-loop schedule.

    ``engines`` maps preset name -> ServingEngine; every engine gets its
    own serve() session for the run.  ``payloads[i]`` is the pre-built
    feature array for ``arrivals[i]`` (generation cost must not pollute
    the timeline).  ``submit_timeout_s=0`` makes backpressure a shed, not
    a stall — the open-loop producer never waits.
    """
    for eng in engines.values():
        eng.start_serving(slo=slo)
    lateness, reqs, rejected = [], [], 0
    # the producer shares the GIL with the scheduler thread; the default
    # 5ms switch interval lets a behind-schedule producer stall the step
    # loop's Python sections for whole step-times at once
    switch = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        t0 = time.perf_counter()
        for n, (arr, payload) in enumerate(zip(arrivals, payloads)):
            t_target = t0 + arr.t
            _sleep_until(t_target)
            late = time.perf_counter() - t_target
            lateness.append(late)
            if late > 0.001 and n % 32 == 31:
                time.sleep(0.0002)   # behind: yield the GIL periodically
            try:
                reqs.append((arr, _engine_for(engines, arr).submit_async(
                    payload, deadline_ms=arr.deadline_ms,
                    priority=arr.priority, timeout=submit_timeout_s)))
            except QueueFull:
                rejected += 1
                reqs.append((arr, None))
        for _, req in reqs:
            if req is not None:
                req.future.result()
        t_end = time.perf_counter()
    finally:
        sys.setswitchinterval(switch)
        for eng in engines.values():
            eng.stop_serving()
    return _metrics(reqs, t0, t_end, rejected=rejected,
                    lateness_s=lateness)


def run_sync(engines: dict, arrivals: list[Arrival], payloads: list) -> dict:
    """Drive the synchronous submit/drain facade with the same schedule.

    One thread alternates "submit everything due" and "drain the queue";
    arrivals due while drain blocks are submitted on return, and their
    latency counts from the intended arrival (no coordinated omission).
    """
    lateness, reqs = [], []
    i = 0
    t0 = time.perf_counter()
    while i < len(arrivals):
        t_target = t0 + arrivals[i].t
        now = time.perf_counter()
        if now < t_target and all(
                eng.scheduler.pending == 0 for eng in engines.values()):
            _sleep_until(t_target)
            now = time.perf_counter()
        submitted = False
        while i < len(arrivals) and t0 + arrivals[i].t <= now:
            arr = arrivals[i]
            lateness.append(now - (t0 + arr.t))
            reqs.append((arr, _engine_for(engines, arr).submit(payloads[i])))
            i += 1
            submitted = True
        if submitted or any(eng.scheduler.pending
                            for eng in engines.values()):
            for eng in engines.values():
                if eng.scheduler.pending:
                    eng.drain()
    for eng in engines.values():
        if eng.scheduler.pending:
            eng.drain()
    t_end = time.perf_counter()
    return _metrics(reqs, t0, t_end, rejected=0, lateness_s=lateness)


def _metrics(reqs, t0: float, t_end: float, *, rejected: int,
             lateness_s) -> dict:
    """Shared per-level metrics: same keys as the per-backend bench rows.

    Latency is measured from the *intended* arrival time (t0 + arrival.t)
    to results-ready, for both modes.  ``throughput_samples_per_s`` is
    served (non-shed) samples over the span from stream start to last
    completion; ``shed_rate`` is shed samples (admission + expiry + late
    + queue-full rejections) over offered samples.
    """
    offered_samples = sum(arr.size for arr, _ in reqs)
    served_lat_ms, served_samples = [], 0
    shed_samples = sum(arr.size for arr, r in reqs if r is None)
    for arr, r in reqs:
        if r is None:                     # backpressure rejection
            continue
        shed = getattr(r, "shed", None)
        if shed is not None:
            shed_samples += arr.size
            continue
        served_samples += arr.size
        served_lat_ms.append((r.t_done - (t0 + arr.t)) * 1e3)
    wall = max(t_end - t0, 1e-9)
    out = {
        "offered_rps": round(len(reqs) / max(
            (reqs[-1][0].t if reqs else 0.0), 1e-9), 1),
        "offered_samples_per_s": round(offered_samples / max(
            (reqs[-1][0].t if reqs else 0.0), 1e-9), 1),
        "throughput_samples_per_s": round(served_samples / wall, 1),
        "served_requests": len(served_lat_ms),
        "shed_requests": sum(1 for arr, r in reqs
                             if r is None or getattr(r, "shed", None)),
        "rejected_requests": rejected,
        "shed_rate": round(shed_samples / offered_samples, 4)
        if offered_samples else 0.0,
        "wall_s": round(wall, 3),
        #: submit-loop lag behind the intended timeline (open-loop health:
        #: large p99 here means the generator, not the engine, was the
        #: bottleneck and the offered load is understated)
        "submit_lag_ms": percentiles([v * 1e3 for v in lateness_s])
        if lateness_s else {},
    }
    if served_lat_ms:
        lat = percentiles(served_lat_ms)
        out["latency_ms_p50"] = lat["p50"]
        out["latency_ms_p99"] = lat["p99"]
        out["latency_ms_p999"] = lat["p999"]
    return out


def measure_capacity(engine, *, requests: int = 24,
                     size: int | None = None) -> float:
    """Closed-loop samples/s ceiling: one warm max-bucket stream through
    the sync facade.  The load levels are fractions of this."""
    size = size if size is not None else engine.scheduler.max_bucket
    engine.warmup(size)
    payloads = [engine.make_request(size, seed=i) for i in range(requests)]
    t0 = time.perf_counter()
    for p in payloads:
        engine.submit(p)
    done = engine.drain()
    wall = time.perf_counter() - t0
    return sum(r.size for r in done) / wall


def run_level(engines: dict, spec: LoadSpec, *, mode: str = "both",
              slo: SLOConfig | None = None) -> dict:
    """One offered-load level end to end: schedule, payloads, run(s)."""
    arrivals = make_arrivals(spec)
    payloads = []
    for i, arr in enumerate(arrivals):
        eng = _engine_for(engines, arr)
        payloads.append(eng.make_request(arr.size, seed=spec.seed + i))
    out = {"rate_rps": round(spec.rate_rps, 1),
           "arrivals": len(arrivals),
           "duration_s": spec.duration_s}
    if mode in ("both", "async"):
        out["continuous"] = run_async(engines, arrivals, payloads, slo=slo)
    if mode in ("both", "sync"):
        out["sync"] = run_sync(engines, arrivals, payloads)
    return out


def main(argv=None):
    from ..serving import ServingEngine

    ap = argparse.ArgumentParser(
        description="open-loop Poisson load generator for DWN serving")
    ap.add_argument("--preset", action="append", default=[],
                    help="DWN preset(s) to serve; repeat for a "
                         "multi-tenant mix (default: dwn-jsc-sm)")
    ap.add_argument("--levels", default="0.5,1.0,1.3",
                    help="offered-load levels as fractions of measured "
                         "closed-loop capacity")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="both",
                    choices=["both", "async", "sync"])
    ap.add_argument("--deadline-ms", type=float, default=50.0,
                    help="per-request SLO deadline (continuous mode)")
    ap.add_argument("--sizes", default="uniform:32:256")
    ap.add_argument("--burst-factor", type=float, default=1.0)
    ap.add_argument("--burst-every", type=float, default=0.0)
    ap.add_argument("--burst-len", type=float, default=0.0)
    ap.add_argument("--max-bucket", type=int, default=256)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--out", default="")
    ap.add_argument("--slo-queue-samples", type=int, default=4096,
                    help="bound on queued samples (SLOConfig."
                         "max_queue_samples); a submit past it is "
                         "rejected (continuous mode)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve (default cuda; never falls back)")
    args = ap.parse_args(argv)

    presets = args.preset or ["dwn-jsc-sm"]
    engines = {p: ServingEngine(p, backend=args.backend,
                                max_bucket=args.max_bucket, n_train=2000,
                                device=args.device)
               for p in presets}
    slo = SLOConfig(max_queue_samples=args.slo_queue_samples)
    capacity = {p: measure_capacity(eng) for p, eng in engines.items()}
    total_cap = sum(capacity.values())
    tenants = tuple(
        Tenant(name=p, weight=capacity[p], size=args.sizes,
               deadline_ms=args.deadline_ms, preset=p) for p in presets)
    # 256 draws of one generator (the reference draws from a new
    # generator each time, so its mean is the first draw's size)
    rng = np.random.default_rng(0)
    mean_size = float(np.mean([t.sample_size(rng)
                               for t in tenants for _ in range(256)]))
    record = {"presets": presets, "capacity_samples_per_s":
              {p: round(c, 1) for p, c in capacity.items()},
              "levels": []}
    for frac in [float(s) for s in args.levels.split(",")]:
        rate = frac * total_cap / mean_size
        spec = LoadSpec(rate_rps=rate, duration_s=args.duration,
                        seed=args.seed, burst_factor=args.burst_factor,
                        burst_every_s=args.burst_every,
                        burst_len_s=args.burst_len, tenants=tenants)
        level = run_level(engines, spec, mode=args.mode, slo=slo)
        level["load_fraction"] = frac
        record["levels"].append(level)
        print(json.dumps(level))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=2)
        print(f"written {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
