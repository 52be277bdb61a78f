"""Resilient sweep execution: fault-tolerant, resumable, straggler-aware.

The port's copy of the reference's ``repro.sweep.executor``; its workers
run the port's pipeline on ``SweepSettings.device``.

``run_grid_parallel`` shards a sweep grid across worker *processes* and
keeps the run alive through every failure domain the serial loop dies on:

* **worker crash / node loss** — each point runs inside the worker under
  ``runtime.fault.Supervisor.supervise`` with a bounded
  :class:`~repro_torch.runtime.fault.RestartPolicy` (in-process faults retry
  with backoff); a worker *process* death is detected by the dispatcher,
  the in-flight point is re-dispatched to a fresh worker, and a point
  whose workers die ``max_restarts + 1`` times is reported as **failed**
  in the :class:`~repro_torch.sweep.results.SweepResult` without aborting the
  remaining grid;
* **run kill / preemption** — every completed point is persisted through
  the config-hash cache (atomic ``os.replace`` writes) the moment it
  finishes, and optionally as a packed ``DWNArtifact`` via
  ``runtime.checkpoint.save_artifact``; a killed run resumes with zero
  recomputed points, and SIGTERM (``runtime.fault.PreemptionHandler``)
  converts to "finish in-flight points, flush, return partial result" —
  the CLI exits 0 and the next invocation continues from the cache;
* **stragglers** — per-point wall times feed a
  ``runtime.straggler.StragglerMonitor``; an in-flight point that
  exceeds the robust-z flag threshold is speculatively re-dispatched to
  a fresh worker and the first result wins, so one slow host never gates
  the grid.

Chaos modes (``ExecutorSettings.chaos``) make all of this testable:

* ``kill-after-N``  — each worker hard-exits (``os._exit``) after
  completing N points: simulated node loss *after* the cache commit;
* ``raise-after-N`` — a ``runtime.fault.FaultInjector`` raises once in
  each worker after N completed points (exercises the in-worker
  ``Supervisor`` retry path);
* ``raise-always``  — every computation attempt raises: the crash-loop
  shape that must end in per-point *failure*, not an infinite spin;
* ``raise-point-I`` — grid index I raises on *every* attempt (one failed
  point must not abort the remaining grid);
* ``stall-I:S``     — the first attempt at grid index I sleeps S seconds
  before computing (exercises straggler speculation).

Workers are spawned (never forked — a CUDA context does not survive a
fork) and lazily build their own
:class:`~repro_torch.sweep.pipeline.SweepRunner` (data + model memo).  On
hosts with more than one card each worker is pinned round-robin via
``CUDA_VISIBLE_DEVICES`` before its first CUDA call; with one card every
worker shares it, so a parallel run's kernel and serve axes are
shared-card numbers.  On the CPU the processes are plain
multiprocessing.  Before spawning, the dispatcher builds the fused
kernels' library once when the workers will launch it, so N workers do
not run N ``nvcc``s at once.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import time

from .cache import SweepCache, point_key
from .grid import SweepPoint, load_grid
from .pipeline import (DEFAULT_CACHE_DIR, SweepSettings, persist_artifact,
                       scan_cache)
from .results import PointResult, SweepResult

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Parsed fault-injection directive (see module docstring)."""

    kill_after: int | None = None
    raise_after: int | None = None
    raise_always: bool = False
    raise_point: int | None = None
    stall_index: int | None = None
    stall_s: float = 0.0

    @classmethod
    def parse(cls, text: str | None) -> "ChaosSpec":
        if not text:
            return cls()
        if text == "raise-always":
            return cls(raise_always=True)
        if text.startswith("kill-after-"):
            return cls(kill_after=int(text.rsplit("-", 1)[1]))
        if text.startswith("raise-after-"):
            return cls(raise_after=int(text.rsplit("-", 1)[1]))
        if text.startswith("raise-point-"):
            return cls(raise_point=int(text.rsplit("-", 1)[1]))
        if text.startswith("stall-"):
            idx, _, secs = text[len("stall-"):].partition(":")
            return cls(stall_index=int(idx), stall_s=float(secs or 1.0))
        raise ValueError(
            f"unknown chaos spec {text!r} (kill-after-N | raise-after-N | "
            f"raise-always | raise-point-I | stall-I:S)")


@dataclasses.dataclass(frozen=True)
class ExecutorSettings:
    """Knobs of the parallel executor (fidelity knobs stay in
    :class:`~repro_torch.sweep.pipeline.SweepSettings`).

    Attributes:
      workers: worker processes; None = min(grid size, CPU count, 4).
      max_restarts: per-point failure budget — counts both in-worker
        retries and re-dispatches after a worker death; a point is failed
        after ``max_restarts + 1`` attempts.
      backoff_s: in-worker retry backoff (seconds).
      straggler_*: StragglerMonitor window/threshold over per-point wall
        times; ``speculate=False`` disables re-dispatch.
      poll_s: dispatcher poll interval (seconds).
      lost_task_timeout_s: watchdog — if nothing completes for this long
        while all workers are idle, unclaimed points are re-queued
        (covers the claim-message race on a crashed worker).
      artifact_dir: when set, every computed point's packed artifact is
        checkpointed here via ``runtime.checkpoint.save_artifact``.
      chaos: fault-injection directive (:class:`ChaosSpec`), None = off.
    """

    workers: int | None = None
    max_restarts: int = 2
    backoff_s: float = 0.05
    straggler_window: int = 32
    straggler_z: float = 4.0
    straggler_min_samples: int = 3
    speculate: bool = True
    poll_s: float = 0.1
    lost_task_timeout_s: float = 300.0
    artifact_dir: str | None = None
    chaos: str | None = None


def _default_workers(n_points: int) -> int:
    return max(1, min(n_points, os.cpu_count() or 1, 4))


def _device_hints(n_workers: int) -> list:
    """Round-robin device pins for hosts with more than one card; None
    entries otherwise (one shared card, or plain multiprocessing on the
    CPU).  ``torch.cuda.device_count`` creates no CUDA context in the
    dispatcher."""
    import torch
    ndev = torch.cuda.device_count()
    if ndev > 1:
        return [str(i % ndev) for i in range(n_workers)]
    return [None] * n_workers


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _worker_main(worker_id: int, task_q, result_q, settings_dict: dict,
                 cache_dir: str | None, artifact_dir: str | None,
                 chaos_text: str | None, max_restarts: int,
                 backoff_s: float, device_hint: str | None) -> None:
    """One worker: pull (index, point, attempt) tasks, run each point
    under a supervised retry loop, commit to the cache (and artifact
    store), report on the result queue.  Runs in a *spawned* process."""
    if device_hint is not None:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", device_hint)
    # workers never own the preemption signal: the dispatcher drains the
    # run; a TERM'd worker is treated as a node loss and re-dispatched
    from ..runtime.fault import FaultInjector, RestartPolicy, Supervisor
    from .pipeline import SweepRunner

    settings = SweepSettings(**settings_dict)
    chaos = ChaosSpec.parse(chaos_text)
    cache = SweepCache(cache_dir)
    runner = None
    completed = 0
    if chaos.raise_always:
        injector = FaultInjector(set(range(1 << 20)), every_step=True)
    else:
        crash = set() if chaos.raise_after is None else {chaos.raise_after}
        injector = FaultInjector(crash)

    while True:
        task = task_q.get()
        if task is None:
            result_q.put(("bye", worker_id))
            return
        index, point_dict, attempt = task
        result_q.put(("claim", worker_id, index, attempt))
        point = SweepPoint.from_dict(point_dict)
        t0 = time.perf_counter()
        key = point_key(point, settings)
        if attempt > 1:
            # a re-dispatched point may already be committed (its first
            # worker died *after* the cache write, or its "done" message
            # was lost with the dying process) — never recompute it
            hit = cache.get(key)
            if hit is not None:
                result_q.put(("done", worker_id, index, attempt, hit,
                              time.perf_counter() - t0, 0, True))
                completed += 1
                continue

        def compute():
            nonlocal runner
            if chaos.stall_index == index and attempt == 1:
                time.sleep(chaos.stall_s)
            if chaos.raise_point == index:
                raise RuntimeError(
                    f"injected persistent fault at grid index {index}")
            injector.maybe_crash(completed)
            if runner is None:                 # lazy: data + jit caches
                runner = SweepRunner(settings)
            return runner.run_point(point)

        # earlier attempts (worker deaths, in-worker retries) draw from
        # the same per-point budget the dispatcher enforces
        budget = max(0, max_restarts - (attempt - 1))
        sup = Supervisor(cache_dir or ".",
                         policy=RestartPolicy(max_restarts=budget,
                                              backoff_s=backoff_s))
        try:
            res = sup.supervise(compute, label=point.label)
        except Exception as e:                 # budget exhausted: terminal
            # sup.restarts counts crashes; the last crash aborted rather
            # than retried, so the retry count is one fewer
            result_q.put(("failed", worker_id, index, attempt,
                          f"{type(e).__name__}: {e}", sup.restarts - 1))
            continue
        cache.put(key, res.to_dict())
        persist_artifact(runner, point, key, artifact_dir)
        wall = time.perf_counter() - t0
        result_q.put(("done", worker_id, index, attempt, res.to_dict(),
                      wall, sup.restarts, False))
        completed += 1
        if chaos.kill_after is not None and completed >= chaos.kill_after:
            # flush the queue's feeder thread first: the point is already
            # committed to the cache, and the parent should learn that
            # before it sees the corpse (lost messages are still safe —
            # the re-dispatch hits the worker-side cache check above)
            result_q.close()
            result_q.join_thread()
            os._exit(17)                       # simulated node loss


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

class _Dispatcher:
    """Parent-side state machine: task/result queues, worker lifecycle,
    restart accounting, straggler speculation, preemption draining."""

    def __init__(self, points, todo, settings, cache, ex, preemption, log):
        self.points = points
        self.settings = settings
        self.cache = cache
        self.ex = ex
        self.preemption = preemption
        self.log = log or (lambda m: None)
        self.ctx = mp.get_context("spawn")
        self.task_q = self.ctx.Queue()
        self.result_q = self.ctx.Queue()
        self.todo = list(todo)
        self.results: dict[int, PointResult] = {}
        self.failed: dict[int, str] = {}
        self.attempts: dict[int, int] = {i: 0 for i in todo}
        self.in_flight: dict[int, tuple] = {}      # wid -> (idx, att, t0)
        self.procs: dict[int, mp.Process] = {}
        self.speculated: set[int] = set()
        self.counters = {"computed": 0, "restarts": 0, "worker_deaths": 0,
                         "stragglers_redispatched": 0, "superseded": 0,
                         "in_worker_retries": 0, "workers_spawned": 0,
                         "worker_cache_hits": 0}
        self.draining = False
        self._next_wid = 0
        from ..runtime.straggler import StragglerMonitor
        self.monitor = StragglerMonitor(
            window=ex.straggler_window, z_threshold=ex.straggler_z,
            min_samples=ex.straggler_min_samples)

    # -- lifecycle ------------------------------------------------------

    def spawn_worker(self, device_hint=None):
        wid = self._next_wid
        self._next_wid += 1
        p = self.ctx.Process(
            target=_worker_main,
            args=(wid, self.task_q, self.result_q,
                  dataclasses.asdict(self.settings),
                  str(self.cache.root) if self.cache.root else None,
                  self.ex.artifact_dir, self.ex.chaos,
                  self.ex.max_restarts, self.ex.backoff_s, device_hint),
            daemon=True)
        p.start()
        self.procs[wid] = p
        self.counters["workers_spawned"] += 1
        return wid

    def dispatch(self, index: int):
        self.attempts[index] += 1
        self.task_q.put((index, self.points[index].to_dict(),
                         self.attempts[index]))

    def unresolved(self) -> list:
        return [i for i in self.todo
                if i not in self.results and i not in self.failed]

    # -- event handling -------------------------------------------------

    def _on_message(self, msg) -> None:
        kind = msg[0]
        if kind == "claim":
            _, wid, index, attempt = msg
            self.in_flight[wid] = (index, attempt, time.perf_counter())
        elif kind == "done":
            _, wid, index, attempt, res_dict, wall, retries, cached = msg
            self.in_flight.pop(wid, None)
            self.counters["in_worker_retries"] += retries
            if index in self.results or index in self.failed:
                self.counters["superseded"] += 1
                return
            self.results[index] = PointResult.from_dict(res_dict)
            if cached:
                self.results[index].cached = True
                self.counters["worker_cache_hits"] += 1
            else:
                self.counters["computed"] += 1
                self.monitor.report(wall)
            n = len(self.results) + len(self.failed)
            self.log(f"[{n}/{len(self.todo)}] "
                     f"{self.points[index].label}: "
                     f"{self.results[index].total_luts} LUTs "
                     f"({wall:.1f}s, worker {wid}"
                     + (f", attempt {attempt}" if attempt > 1 else "") + ")")
        elif kind == "failed":
            _, wid, index, attempt, error, retries = msg
            self.in_flight.pop(wid, None)
            self.counters["in_worker_retries"] += retries
            if index not in self.results and index not in self.failed:
                self.failed[index] = error
                self.log(f"POINT FAILED {self.points[index].label}: {error} "
                         f"(restart budget exhausted)")
        elif kind == "bye":
            _, wid = msg
            self.in_flight.pop(wid, None)
            p = self.procs.pop(wid, None)
            if p is not None:
                p.join(timeout=5)

    def _reap_dead_workers(self) -> None:
        """A dead worker's in-flight point re-dispatches (bounded); a
        replacement worker spawns while work remains."""
        for wid in [w for w, p in self.procs.items() if not p.is_alive()]:
            self.procs.pop(wid).join(timeout=1)
            self.counters["worker_deaths"] += 1
            task = self.in_flight.pop(wid, None)
            if task is not None:
                index, attempt, _ = task
                if index in self.results or index in self.failed:
                    pass                        # superseded: nothing lost
                elif attempt > self.ex.max_restarts:
                    self.failed[index] = (
                        f"worker died (attempt {attempt}, "
                        f"restart budget {self.ex.max_restarts} exhausted)")
                    self.log(f"POINT FAILED {self.points[index].label}: "
                             f"{self.failed[index]}")
                else:
                    self.counters["restarts"] += 1
                    self.log(f"worker {wid} died at "
                             f"{self.points[index].label}; re-dispatching "
                             f"(attempt {attempt + 1})")
                    self.dispatch(index)
            if self.unresolved() and not self.draining:
                self.spawn_worker()

    def _check_stragglers(self) -> None:
        if not self.ex.speculate or self.draining:
            return
        thr = self.monitor.threshold_s()
        if thr is None:
            return
        now = time.perf_counter()
        for wid, (index, attempt, t0) in list(self.in_flight.items()):
            if (now - t0 > thr and index not in self.speculated
                    and index not in self.results
                    and index not in self.failed
                    and attempt <= self.ex.max_restarts):
                self.speculated.add(index)
                self.counters["stragglers_redispatched"] += 1
                self.log(f"straggler: {self.points[index].label} in flight "
                         f"{now - t0:.1f}s > {thr:.1f}s; speculatively "
                         f"re-dispatching to a fresh worker")
                self.dispatch(index)
                self.spawn_worker()             # never gate on the slow one

    def _drain_task_queue(self) -> None:
        try:
            while True:
                self.task_q.get_nowait()
        except queue_mod.Empty:
            pass

    # -- main loop ------------------------------------------------------

    def run(self) -> None:
        n_workers = self.ex.workers or _default_workers(len(self.todo))
        n_workers = max(1, min(n_workers, len(self.todo)))
        s = self.settings
        if s.device == "cuda" and (s.kernel or s.serve):
            from ..kernels import _build
            _build.build_all(["fused_dwn"])
        for hint in _device_hints(n_workers):
            self.spawn_worker(device_hint=hint)
        for i in self.todo:
            self.dispatch(i)
        last_progress = time.perf_counter()
        while self.unresolved():
            if self.preemption.requested and not self.draining:
                self.draining = True
                self._drain_task_queue()
                self.log(f"preemption: draining — finishing "
                         f"{len(self.in_flight)} in-flight point(s), "
                         f"cache is flushed per point")
            if self.draining and not self.in_flight:
                break
            try:
                msg = self.result_q.get(timeout=self.ex.poll_s)
            except queue_mod.Empty:
                msg = None
            if msg is not None:
                self._on_message(msg)
                last_progress = time.perf_counter()
                # drain whatever else is already queued
                try:
                    while True:
                        self._on_message(self.result_q.get_nowait())
                except queue_mod.Empty:
                    pass
            self._reap_dead_workers()
            self._check_stragglers()
            if (not self.in_flight and msg is None
                    and time.perf_counter() - last_progress
                    > self.ex.lost_task_timeout_s):
                # claim-race watchdog: a worker died between task pickup
                # and its claim message — re-queue every unresolved point
                self.log("watchdog: no progress and no claims; re-queueing "
                         f"{len(self.unresolved())} unresolved point(s)")
                for i in self.unresolved():
                    if self.attempts[i] > self.ex.max_restarts:
                        self.failed[i] = "lost task (restarts exhausted)"
                    else:
                        self.dispatch(i)
                last_progress = time.perf_counter()
        self.shutdown()

    def shutdown(self) -> None:
        # a worker still grinding on a point someone else already won
        # must not gate the run's exit — kill it, its result is moot
        for wid, (index, _, _) in list(self.in_flight.items()):
            if index in self.results or index in self.failed:
                p = self.procs.pop(wid, None)
                if p is not None:
                    p.terminate()
                    p.join(timeout=2)
                self.in_flight.pop(wid, None)
        for _ in range(len(self.procs) + 2):
            try:
                self.task_q.put_nowait(None)
            except Exception:                   # pragma: no cover
                break
        deadline = time.time() + 10
        for p in self.procs.values():
            p.join(timeout=max(0.1, deadline - time.time()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
        self.task_q.cancel_join_thread()
        self.result_q.cancel_join_thread()


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def run_grid_parallel(grid, settings: SweepSettings | None = None, *,
                      cache_dir: str | None = DEFAULT_CACHE_DIR,
                      fresh: bool = False,
                      executor: ExecutorSettings | None = None,
                      preemption=None, log=None) -> SweepResult:
    """Run a grid through worker processes with fault tolerance.

    Same contract as :func:`~repro_torch.sweep.pipeline.run_grid` (same cache,
    same :class:`SweepResult`) plus the executor block in the result:
    computed / cache-hit counts, failed points, restart + straggler
    counters, and the ``interrupted`` flag when a preemption drained the
    run early (unfinished points are listed in ``remaining_points`` and
    simply resume from the cache on the next invocation).

    Args:
      grid: named grid / JSON path / list of :class:`SweepPoint`.
      settings: fidelity knobs (:class:`SweepSettings`).
      cache_dir: result-cache root; None disables resume (discouraged —
        a killed run then recomputes everything).
      fresh: ignore (but still refresh) the cache.
      executor: :class:`ExecutorSettings` (workers, restarts, chaos...).
      preemption: injectable ``runtime.fault.PreemptionHandler``; by
        default one is installed on SIGTERM in this (main) thread.
      log: optional ``print``-like progress callback.
    """
    from ..runtime.fault import PreemptionHandler

    settings = settings or SweepSettings()
    ex = executor or ExecutorSettings()
    ChaosSpec.parse(ex.chaos)                  # validate early
    points = load_grid(grid) if isinstance(grid, str) else list(grid)
    name = grid if isinstance(grid, str) else "custom"
    cache = SweepCache(cache_dir)
    t_start = time.perf_counter()
    hits = scan_cache(points, settings, cache, fresh)
    todo = [i for i in range(len(points)) if i not in hits]
    if log:
        log(f"executor: {len(hits)}/{len(points)} points from cache, "
            f"{len(todo)} to compute")
    preemption = preemption or PreemptionHandler(install=True)

    disp = None
    if todo:
        disp = _Dispatcher(points, todo, settings, cache, ex, preemption,
                           log)
        disp.run()

    out, remaining = [], []
    for i, point in enumerate(points):
        if i in hits:
            out.append(hits[i])
        elif disp and i in disp.results:
            out.append(disp.results[i])
        elif disp and i in disp.failed:
            out.append(PointResult(point=point, failed=True,
                                   error=disp.failed[i]))
        else:
            remaining.append(point.label)
    counters = disp.counters if disp else {
        "computed": 0, "restarts": 0, "worker_deaths": 0,
        "stragglers_redispatched": 0, "superseded": 0,
        "in_worker_retries": 0, "workers_spawned": 0,
        "worker_cache_hits": 0}
    executor_block = {
        "mode": "parallel",
        "workers": (ex.workers or _default_workers(max(len(todo), 1))),
        "cache_hits": len(hits),
        "failed": [points[i].label for i in sorted(disp.failed)]
        if disp else [],
        "interrupted": bool(disp.draining) if disp else False,
        "remaining": len(remaining),
        "remaining_points": remaining,
        "chaos": ex.chaos,
        "cache": dict(cache.stats),
        "wall_s": round(time.perf_counter() - t_start, 3),
        **counters,
    }
    return SweepResult(grid=name, settings=dataclasses.asdict(settings),
                       points=out, executor=executor_block)


__all__ = ["ChaosSpec", "ExecutorSettings", "run_grid_parallel"]
