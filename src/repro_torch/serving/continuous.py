"""Continuous-batching request loop with SLO-aware admission control.

The port's own copy of the reference's ``repro.serving.continuous``
(numpy and ``threading``, no torch): batch formation, dense packing,
oversize chunking, admission, expiry and late marking decide as the
reference's do, step for step.

The synchronous ``MicrobatchScheduler`` coalesces requests in strict
admission order and blocks the caller in ``drain()`` — a closed-loop
measurement device, not a serving engine.  This module is the open-loop
core: a dedicated scheduler thread keeps device steps in flight while new
requests stream in from any number of submitting threads, and every
request completes **out of order** through its own future.

Design:

* **Batch formation at step boundaries.**  At each step the loop takes
  whatever is queued, ordered by (priority desc, deadline asc, admission
  order) — earliest-deadline-first within a priority class — coalesces
  up to ``max_bucket`` samples, and pads to the same power-of-two bucket
  ladder the sync scheduler uses, so the per-(backend, bucket) step cache
  (one CUDA graph each on the card) and the tuned kernel configs carry
  over unchanged.
* **Oversize chunking without clock restarts.**  A request larger than
  ``max_bucket`` is served in max-bucket chunks across consecutive
  steps; its queue time is attributed from the *original submit* to the
  *first* chunk launch, and its future resolves once after the last
  chunk.
* **SLO-aware admission.**  A request may declare a deadline.  Admission
  rejects (types the result as shed, never raises) work that provably
  cannot meet its deadline given the samples queued ahead of it and the
  per-bucket step-time estimates (``backends.StepTimeEstimator`` — seeded
  from the ``AutoSelector`` calibration, refined online from every step).
  Queued work whose deadline expires before it can launch is shed at the
  step boundary instead of being served late; work that still completes
  past its deadline (estimates are estimates) is returned **marked
  shed** — a deadline-constrained request is never returned late without
  the marking.
* **Backpressure.**  Queue depth is bounded in *samples*; ``submit``
  blocks up to ``timeout`` for space and then raises :class:`QueueFull`,
  so an open-loop producer feels the engine's capacity instead of
  growing an unbounded heap.
* **A failed step fails the session.**  An exception from ``step`` is set
  on the futures of the batch it was serving and of every queued
  request, later submits raise, and :meth:`ContinuousScheduler.stop`
  raises it; no caller waits on a future that cannot resolve.

The loop is model-agnostic: ``step(x)`` takes a bucket-padded array and
returns a tuple of per-sample result arrays, exactly the
``drain_batched`` contract.  ``step_once()`` runs one scheduling decision
plus one step synchronously — the unit tests drive it without threads,
so ordering assertions are deterministic.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from .scheduler import Request, bucket_for, power_of_two_buckets

#: shed reasons (the typed result's ``shed`` field)
SHED_ADMISSION = "admission"      # provably unmeetable deadline at submit
SHED_EXPIRED = "expired"          # deadline passed while queued
SHED_LATE = "late"                # served, but results ready past deadline
SHED_SHUTDOWN = "shutdown"        # scheduler stopped without draining


class QueueFull(RuntimeError):
    """Backpressure: the bounded queue had no room within the timeout."""


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """What an async request's future resolves to.

    ``ok`` means served on time (or no deadline declared).  ``shed`` is
    one of the SHED_* reasons otherwise; ``value`` still carries the
    results for ``SHED_LATE`` (the work was done, just late) and is None
    for requests that never ran.
    """

    ok: bool
    value: Any
    shed: str | None
    rid: int


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Service-level objectives for the continuous-batching loop.

    Attributes:
      max_queue_samples: backpressure bound on queued (not yet launched)
        samples; ``submit`` blocks then raises :class:`QueueFull`.
      submit_timeout_s: default time ``submit`` waits for queue space
        when the caller passes ``timeout=None``.
      admission_slack: multiplier on the step-time estimates used by
        admission control.  < 1.0 is optimistic (sheds only work that is
        provably late even under a rosy estimate), > 1.0 sheds earlier.
      deadline_default_ms: deadline applied to requests that don't
        declare one (None = no implicit deadline).
    """

    max_queue_samples: int = 4096
    submit_timeout_s: float = 1.0
    admission_slack: float = 1.0
    deadline_default_ms: float | None = None


@dataclasses.dataclass
class AsyncRequest(Request):
    """A :class:`Request` plus async-serving state.

    ``future`` resolves to a :class:`ServeResult` — possibly before the
    request ever reaches the queue (admission shed).  ``deadline`` is an
    absolute ``timer()`` timestamp or None.
    """

    priority: int = 0
    deadline: float | None = None
    future: Future = dataclasses.field(default_factory=Future)
    shed: str | None = None
    #: samples already launched (oversize requests span several steps)
    offset: int = 0
    #: per-chunk result tuples, concatenated at completion
    parts: list = dataclasses.field(default_factory=list)

    @property
    def remaining(self) -> int:
        return self.size - self.offset

    def sort_key(self):
        # priority classes first, earliest deadline within a class,
        # admission order for deadline ties / no-deadline traffic
        return (-self.priority,
                self.deadline if self.deadline is not None else math.inf,
                self.rid)


class ContinuousScheduler:
    """The continuous-batching loop behind ``ServingEngine.serve()``.

    Args:
      step: ``step(x) -> tuple[per-sample arrays]`` on a bucket-padded
        batch; must block until results are ready (its wall time is the
        compute measurement and the estimator update).
      max_bucket / min_bucket: the power-of-two bucket ladder (identical
        to the sync scheduler's, so compiles are shared).
      slo: :class:`SLOConfig`; None = defaults (large queue, no implicit
        deadlines).
      estimator: per-bucket step-time estimates for admission control
        (``backends.StepTimeEstimator`` or any object with
        ``estimate(bucket) -> float | None`` and ``update(bucket, s)``).
        None disables admission-time shedding (expiry and late marking
        still apply: those need no estimate).
      monitor: optional ``runtime.straggler.StragglerMonitor``; every
        step's wall time is reported, anomalies surface in
        ``counters()``.
      timer: injectable clock (tests use a deterministic one).
    """

    def __init__(self, step: Callable, *, max_bucket: int = 256,
                 min_bucket: int = 8, slo: SLOConfig | None = None,
                 estimator=None, monitor=None,
                 timer: Callable[[], float] = time.perf_counter):
        self.buckets = power_of_two_buckets(
            min(min_bucket, max_bucket), max_bucket)
        self.max_bucket = max_bucket
        self.slo = slo if slo is not None else SLOConfig()
        self.estimator = estimator
        self.monitor = monitor
        self._step = step
        self._timer = timer
        # RLock: _finish() takes the lock for the completed/shed counters
        # and is reached both from submit() (admission shed, lock held)
        # and from the scheduler thread (lock not held)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        #: kept sorted by sort_key at insert time (bisect.insort), so the
        #: step loop never re-sorts; partial takes stay at the front
        self._pending: list[AsyncRequest] = []
        self._queued_samples = 0
        self._deadline_pending = 0   # queued requests carrying a deadline
        self._next_rid = 0
        self._thread: threading.Thread | None = None
        self._stopping = False
        # -- observables -------------------------------------------------
        #: slim copies of every finished request (served or shed), the
        #: report()/latency_stats source; payload/result dropped
        self.completed: list[AsyncRequest] = []
        self.shed_counts: dict[str, int] = {}
        self.steps = 0
        self.busy_s = 0.0            # sum of step wall times
        self.session_wall_s = 0.0    # start() -> stop() wall, accumulated
        self.max_depth_samples = 0
        self.max_depth_requests = 0
        self._t_session = None
        #: the exception a step raised, which ended the loop (None: none)
        self.error: BaseException | None = None

    # ------------------------------------------------------------------
    # submission (any thread)
    # ------------------------------------------------------------------

    def submit(self, payload: Any, size: int | None = None, *,
               deadline_ms: float | None = None, priority: int = 0,
               timeout: float | None = None) -> AsyncRequest:
        """Admit one request; returns it with ``future`` attached.

        Blocks up to ``timeout`` seconds (None = ``slo.submit_timeout_s``)
        when the bounded queue is full, then raises :class:`QueueFull`.
        A request whose deadline provably cannot be met is *not* queued:
        its future resolves immediately to a ``ServeResult`` with
        ``shed == SHED_ADMISSION``.
        """
        if size is None:
            size = int(np.asarray(payload).shape[0])
        timeout = self.slo.submit_timeout_s if timeout is None else timeout
        if deadline_ms is None:
            deadline_ms = self.slo.deadline_default_ms
        t_submit = self._timer()
        deadline = (t_submit + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        with self._cond:
            self._raise_if_failed()
            if self._stopping:
                raise RuntimeError("scheduler is stopped")
            t_wait_end = t_submit + timeout
            while self._queued_samples + size > self.slo.max_queue_samples:
                self._raise_if_failed()
                left = t_wait_end - self._timer()
                if left <= 0 or self._stopping:
                    raise QueueFull(
                        f"queue full: {self._queued_samples} samples "
                        f"queued, bound {self.slo.max_queue_samples}, "
                        f"request of {size} timed out after {timeout}s")
                self._cond.wait(left)
            req = AsyncRequest(rid=self._next_rid, payload=payload,
                               size=size, t_submit=t_submit,
                               priority=priority, deadline=deadline)
            self._next_rid += 1
            if deadline is not None:
                est = self._admission_estimate_locked(req)
                if (est is not None and
                        self._timer() + est * self.slo.admission_slack
                        > deadline):
                    self._finish(req, shed=SHED_ADMISSION)
                    return req
            bisect.insort(self._pending, req, key=AsyncRequest.sort_key)
            self._queued_samples += size
            if deadline is not None:
                self._deadline_pending += 1
            self.max_depth_samples = max(self.max_depth_samples,
                                         self._queued_samples)
            self.max_depth_requests = max(self.max_depth_requests,
                                          len(self._pending))
            self._cond.notify_all()
        return req

    def _admission_estimate_locked(self, req: AsyncRequest) -> float | None:
        """Lower-bound seconds until ``req`` could complete, or None.

        The bound assumes perfect batching of everything scheduled ahead
        of the request (same-or-better sort key) into max-bucket steps,
        plus the request's own chunks — optimistic, so a shed on this
        estimate means the deadline was provably unmeetable.
        """
        if self.estimator is None:
            return None
        est_max = self.estimator.estimate(self.max_bucket)
        if est_max is None:
            return None
        idx = bisect.bisect_left(self._pending, req.sort_key(),
                                 key=AsyncRequest.sort_key)
        ahead = sum(r.size - r.offset for r in self._pending[:idx])
        wait = math.ceil(ahead / self.max_bucket) * est_max
        own = 0.0
        remaining = req.size
        while remaining > 0:
            chunk = min(remaining, self.max_bucket)
            b = bucket_for(chunk, self.buckets)
            own += self.estimator.estimate(b) or est_max
            remaining -= chunk
        return wait + own

    # ------------------------------------------------------------------
    # completion plumbing
    # ------------------------------------------------------------------

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            raise RuntimeError("the serving loop failed") from self.error

    def _fail(self, exc: BaseException) -> None:
        """End the session on a failed step: every queued request's
        future raises ``exc`` (the batch in flight already does)."""
        with self._cond:
            self.error = exc
            dropped, self._pending = self._pending, []
            self._queued_samples = 0
            self._deadline_pending = 0
            self._cond.notify_all()
        for r in dropped:
            if not r.future.done():
                r.future.set_exception(exc)

    def _finish(self, req: AsyncRequest, *, shed: str | None,
                value: Any = None) -> None:
        """Record + resolve one request (safe from any thread)."""
        req.shed = shed
        with self._lock:
            if shed is not None:
                self.shed_counts[shed] = self.shed_counts.get(shed, 0) + 1
            self.completed.append(dataclasses.replace(
                req, payload=None, result=None, parts=[]))
        req.future.set_result(ServeResult(ok=shed is None, value=value,
                                          shed=shed, rid=req.rid))

    # ------------------------------------------------------------------
    # the step loop (scheduler thread, or step_once from tests)
    # ------------------------------------------------------------------

    def _form_batch_locked(self, now: float):
        """One scheduling decision: (batch slices, expired requests).

        ``batch`` is a list of ``(request, lo, hi)`` payload row slices
        totalling <= max_bucket, packed **densely**: requests are taken
        in sort order and the one straddling the bucket boundary is
        split — its head rows fill this step, the rest stays queued
        (front of its priority class) for the next step.  Oversize
        requests fall out of the same rule as max-bucket chunks.  Dense
        packing is what makes the continuous path's steady-state
        samples/step match the sync facade's instead of padding away
        ~half of each bucket on ragged sizes.  Requests whose deadline
        can no longer be met even if launched immediately are pulled out
        as ``expired``.
        """
        expired: list[AsyncRequest] = []
        if self._deadline_pending:
            est_max = (self.estimator.estimate(self.max_bucket)
                       if self.estimator is not None else None)
            # any request whose deadline clears now + the max possible
            # floor cannot expire this step — skip its bucket math
            cutoff = now + (est_max or 0.0) * self.slo.admission_slack
            floors: dict[int, float] = {}
            keep: list[AsyncRequest] = []
            for r in self._pending:
                if r.deadline is not None and r.deadline < cutoff:
                    floor = 0.0
                    if est_max is not None:
                        b = bucket_for(min(r.size - r.offset,
                                           self.max_bucket), self.buckets)
                        floor = floors.get(b)
                        if floor is None:
                            floor = ((self.estimator.estimate(b) or est_max)
                                     * self.slo.admission_slack)
                            floors[b] = floor
                    if now + floor > r.deadline:
                        expired.append(r)
                        self._queued_samples -= r.size - r.offset
                        self._deadline_pending -= 1
                        continue
                keep.append(r)
            if expired:
                self._pending = keep
        batch: list[tuple[AsyncRequest, int, int]] = []
        total = 0
        for r in self._pending:
            if total >= self.max_bucket:
                break
            take = min(r.size - r.offset, self.max_bucket - total)
            batch.append((r, r.offset, r.offset + take))
            r.offset += take
            self._queued_samples -= take
            total += take
        if batch:
            still: list[AsyncRequest] = []
            for r in self._pending:
                if r.offset < r.size:
                    still.append(r)
                else:
                    if r.deadline is not None:
                        self._deadline_pending -= 1
            self._pending = still
        if batch or expired:
            self._cond.notify_all()    # space freed: wake submitters
        return batch, expired

    def step_once(self, *, wait_s: float = 0.0) -> int:
        """Run one scheduling decision + one device step synchronously.

        Returns the number of samples launched (0 if the queue was empty
        after waiting ``wait_s``).  The thread loop is just this method
        on repeat; tests call it directly for deterministic ordering.
        """
        with self._cond:
            if not self._pending and wait_s > 0:
                self._cond.wait(wait_s)
            now = self._timer()
            batch, expired = self._form_batch_locked(now)
        for r in expired:
            self._finish(r, shed=SHED_EXPIRED)
        if not batch:
            return 0
        t_start = self._timer()
        for r, _, _ in batch:
            if r.t_start == 0.0:      # first launch only: no clock restart
                r.t_start = t_start
        xs = [np.asarray(r.payload)[lo:hi] for r, lo, hi in batch]
        total = sum(x.shape[0] for x in xs)
        bucket = bucket_for(total, self.buckets)
        x = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        if bucket > total:
            pad = np.zeros((bucket - total,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        try:
            outs = self._step(x)
        except BaseException as exc:
            for r, _, _ in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
            raise
        t_done = self._timer()
        step_s = t_done - t_start
        self.steps += 1
        self.busy_s += step_s
        if self.estimator is not None:
            self.estimator.update(bucket, step_s)
        if self.monitor is not None:
            self.monitor.report(step_s)
        off = 0
        for r, lo, hi in batch:
            n = hi - lo
            r.parts.append(tuple(np.asarray(o)[off:off + n] for o in outs))
            r.buckets = r.buckets + (bucket,)
            off += n
            if r.offset >= r.size:    # fully served: resolve the future
                r.t_done = t_done
                if len(r.parts) == 1:
                    result = r.parts[0]
                else:
                    result = tuple(np.concatenate(parts, axis=0)
                                   for parts in zip(*r.parts))
                r.result = result
                late = r.deadline is not None and t_done > r.deadline
                self._finish(r, shed=SHED_LATE if late else None,
                                    value=result)
        return total

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _loop(self) -> None:
        try:
            while True:
                with self._lock:
                    idle = not self._pending
                    if self._stopping and idle:
                        return
                self.step_once(wait_s=0.002 if idle else 0.0)
        except Exception as exc:    # stop() raises it
            self._fail(exc)

    def start(self) -> None:
        assert self._thread is None, "already started"
        self._stopping = False
        self._t_session = self._timer()
        self._thread = threading.Thread(target=self._loop,
                                        name="repro_torch-serve-loop",
                                        daemon=True)
        self._thread.start()

    def stop(self, *, drain: bool = True) -> None:
        """Stop the loop.  ``drain=True`` serves everything queued first;
        ``drain=False`` sheds queued requests with ``SHED_SHUTDOWN``.
        Raises ``RuntimeError`` (from the step's exception) if a step
        failed during the session."""
        assert self._thread is not None, "not started"
        if not drain:
            with self._cond:
                dropped, self._pending = self._pending, []
                self._queued_samples = 0
                self._deadline_pending = 0
                self._cond.notify_all()
            for r in dropped:
                self._finish(r, shed=SHED_SHUTDOWN)
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join()
        self._thread = None
        self.session_wall_s += self._timer() - self._t_session
        self._t_session = None
        self._raise_if_failed()

    # ------------------------------------------------------------------
    # observables
    # ------------------------------------------------------------------

    @property
    def pending_samples(self) -> int:
        return self._queued_samples

    @property
    def pending(self) -> int:
        return len(self._pending)

    def counters(self) -> dict:
        """JSON-able loop counters for ``ServingEngine.report()``."""
        served = [r for r in self.completed if r.shed is None]
        shed = len(self.completed) - len(served)
        out = {
            "steps": self.steps,
            "busy_s": round(self.busy_s, 4),
            "session_wall_s": round(
                self.session_wall_s + (self._timer() - self._t_session
                                       if self._t_session is not None
                                       else 0.0), 4),
            "served_requests": len(served),
            "served_samples": sum(r.size for r in served),
            "shed_requests": shed,
            "shed_by_reason": dict(self.shed_counts),
            "shed_rate": round(shed / len(self.completed), 4)
            if self.completed else 0.0,
            "queue_depth_max_samples": self.max_depth_samples,
            "queue_depth_max_requests": self.max_depth_requests,
        }
        if self.monitor is not None:
            out["straggler"] = {
                "window": len(self.monitor.times),
                "events": len(self.monitor.events),
                "last_z": round(self.monitor.events[-1].z, 2)
                if self.monitor.events else None,
            }
        return out


__all__ = [
    "AsyncRequest", "ContinuousScheduler", "QueueFull", "SLOConfig",
    "ServeResult", "SHED_ADMISSION", "SHED_EXPIRED", "SHED_LATE",
    "SHED_SHUTDOWN",
]
