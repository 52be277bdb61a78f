"""Continuous batching in the port, held to the reference step by step.

* The scheduler: each scripted scenario drives the reference's
  ``repro.serving.continuous.ContinuousScheduler`` and the port's with the
  same fake clock, the same submits and the same ``step_once`` calls; each
  step's rows and bucket, every ``ServeResult``, the completed requests'
  timestamps and buckets, and ``counters()`` must be equal (exact).
* ``StepTimeEstimator``, ``estimator_from_calibration`` and
  ``StragglerMonitor`` against the reference's on the same inputs (exact).
* The engine: a dwn-jsc-sm artifact the reference fitted and saved, served
  by the port through ``serve()`` / ``submit_async``, equal element for
  element to the port's sync drain and to the reference engine's async
  results; the SLO invariant under saturation on an injected clock.
* The launch counters under threads: a recording holds its own thread's
  launches only, and concurrent adds are not lost.

No assertion reads the wall clock; every wait on a future or a thread has
a timeout.
"""

import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dwn import DWNArtifact as JArtifact  # noqa: E402
from repro.dwn import get_spec as jget_spec  # noqa: E402
from repro.runtime import straggler as jstraggler  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import backends as jbackends  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.workloads import load_workload  # noqa: E402
from repro_torch.dwn import DWNArtifact  # noqa: E402
from repro_torch.kernels import _launch  # noqa: E402
from repro_torch.runtime import straggler as tstraggler  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import backends as tbackends  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402

PACKAGES = {"reference": (jcont, jbackends, jstraggler),
            "port": (tcont, tbackends, tstraggler)}
WAIT_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a torch pool over every core in each of them slows all
    of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """Deterministic timer: advances only when told."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class ConstEstimator:
    """Every bucket costs ``seconds`` a step; records the updates."""

    def __init__(self, seconds):
        self.seconds = seconds
        self.updates = []

    def estimate(self, bucket):
        return self.seconds

    def update(self, bucket, seconds):
        self.updates.append((bucket, seconds))


def _payload(rid, n):
    """Rows tagged rid * 1000 + row, so a step's rows name their slices."""
    x = np.zeros((n, 2), np.float64)
    x[:, 0] = rid * 1000 + np.arange(n)
    x[:, 1] = rid
    return x


def _result(res):
    return (res.ok, res.shed, res.rid,
            None if res.value is None else [v.tolist() for v in res.value])


class Harness:
    """One package's scheduler under a script: records what every step
    ran (bucket and tagged rows) and what every submit returned."""

    def __init__(self, cont, *, step_s=0.0, **kwargs):
        self.cont, self.clock, self.step_s = cont, FakeClock(), step_s
        self.trace, self.reqs = [], []
        self.sched = cont.ContinuousScheduler(self._step, timer=self.clock,
                                              **kwargs)

    def _step(self, x):
        self.clock.advance(self.step_s)
        self.trace.append(("step", x.shape[0], x[:, 0].tolist()))
        return x.sum(1), x[:, 0].copy()

    def submit(self, rid_tag, n, **kwargs):
        try:
            req = self.sched.submit(_payload(rid_tag, n), **kwargs)
        except self.cont.QueueFull:
            self.trace.append(("queue-full", rid_tag))
            return None
        self.reqs.append(req)
        self.trace.append(("submit", req.rid, req.future.done()))
        return req

    def step(self):
        self.trace.append(("launched", self.sched.step_once()))

    def outcome(self):
        """Everything the parity test compares, as plain values."""
        results = [_result(r.future.result(timeout=WAIT_S))
                   for r in self.reqs]
        done = [(r.rid, r.size, r.t_submit, r.t_start, r.t_done, r.buckets,
                 r.shed, r.deadline, r.priority, r.offset)
                for r in self.sched.completed]
        timing = [(r.rid, r.t_start, r.t_done, r.buckets, r.queue_ms,
                   r.compute_ms) for r in self.reqs]
        return self.trace, results, done, timing, self.sched.counters()


def _priority(h):
    h.submit(0, 8, priority=0)
    h.submit(1, 8, priority=1)
    h.step()
    h.step()


def _edf(h):
    h.submit(0, 8, deadline_ms=10_000.0)
    h.submit(1, 8, deadline_ms=1_000.0)
    h.step()
    h.step()


def _dense_and_oversize(h):
    for rid, n in ((0, 5), (1, 5), (2, 20), (3, 3)):
        h.submit(rid, n)
    while h.sched.pending:
        h.step()


def _admission_shed(h):
    h.sched.estimator = ConstEstimator(1.0)
    h.submit(0, 4, deadline_ms=10.0)
    h.sched.estimator = ConstEstimator(1e-4)
    h.submit(1, 4, deadline_ms=10.0)
    h.step()


def _expiry(h):
    h.submit(0, 4, deadline_ms=50.0)
    h.submit(1, 4)
    h.clock.advance(0.06)
    h.step()


def _late(h):
    h.step_s = 0.1
    h.submit(0, 4, deadline_ms=50.0)
    h.submit(1, 4, deadline_ms=500.0)
    h.step()


def _backpressure(h):
    h.sched.slo = h.cont.SLOConfig(max_queue_samples=8,
                                   submit_timeout_s=0.0)
    h.submit(0, 8)
    h.submit(1, 1)
    h.step()
    h.submit(2, 1)
    h.step()


def _stop_without_drain(h):
    gate, started = threading.Event(), threading.Event()
    step = h.sched._step

    def held(x):
        started.set()
        assert gate.wait(timeout=WAIT_S)
        return step(x)
    h.sched._step = held
    h.sched.start()
    h.submit(0, 8)
    assert started.wait(timeout=WAIT_S)      # request 0 is in flight
    h.submit(1, 8)                           # queued behind it
    stopper = threading.Thread(target=lambda: h.sched.stop(drain=False))
    stopper.start()
    res = h.reqs[1].future.result(timeout=WAIT_S)
    h.trace.append(("shed-before-step-ends", _result(res)))
    gate.set()
    stopper.join(timeout=WAIT_S)
    assert not stopper.is_alive()


def _queue_time_across_chunks(h):
    h.step_s = 1.0
    h.submit(0, 20)
    h.clock.advance(5.0)
    while h.sched.pending:
        h.step()


def _estimator_updates(h):
    h.step_s = 0.25
    h.sched.estimator = est = ConstEstimator(1e-6)
    h.submit(0, 6)
    h.submit(1, 12)
    while h.sched.pending:
        h.step()
    h.trace.append(("updates", est.updates))


def _mixed(h):
    """A seeded stream of submits (sizes 1-20, priorities 0-2, deadlines
    or none), steps of random length and idle time, against the package's
    own StepTimeEstimator and a bounded queue."""
    h.sched.estimator = h.estimator_cls()
    h.sched.estimator.seed(8, 0.004)
    h.sched.slo = h.cont.SLOConfig(max_queue_samples=48,
                                   submit_timeout_s=0.0)
    rng = np.random.default_rng(5)
    for i in range(160):
        op = rng.random()
        if op < 0.55:
            dl = (None if rng.random() < 0.3
                  else float(rng.uniform(2.0, 60.0)))
            h.submit(i, int(rng.integers(1, 21)),
                     priority=int(rng.integers(0, 3)), deadline_ms=dl)
        elif op < 0.9:
            h.step_s = float(rng.uniform(0.001, 0.012))
            h.step()
        else:
            h.clock.advance(float(rng.uniform(0.0, 0.02)))
    while h.sched.pending:
        h.step()


SCENARIOS = {
    "priority": _priority, "edf": _edf,
    "dense_packing_and_oversize_chunking": _dense_and_oversize,
    "admission_shed": _admission_shed, "expiry_at_step_boundary": _expiry,
    "late_marking": _late, "backpressure_then_drain": _backpressure,
    "stop_without_drain": _stop_without_drain,
    "queue_time_across_chunks": _queue_time_across_chunks,
    "estimator_updates": _estimator_updates, "mixed_seeded_stream": _mixed,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_step_by_step_equals_the_reference(scenario):
    """Exact: the same script on both schedulers (max_bucket 8) gives the
    same steps (bucket and rows, so the (rid, lo, hi) slices), submits,
    results, timestamps, buckets and counters."""
    outcomes = {}
    for name, (cont, backends, _) in PACKAGES.items():
        h = Harness(cont, max_bucket=8, min_bucket=8)
        h.estimator_cls = backends.StepTimeEstimator
        SCENARIOS[scenario](h)
        outcomes[name] = h.outcome()
    ref, port = outcomes["reference"], outcomes["port"]
    for part, a, b in zip(("trace", "results", "completed", "timing",
                           "counters"), ref, port):
        assert a == b, part
    steps = [e for e in port[0] if e[0] == "step"]
    assert steps or scenario in ("admission_shed", "expiry_at_step_boundary")
    assert all(b == 8 for _, b, _ in steps)


def test_a_failed_step_fails_the_session():
    """The port's loop sets a step's exception on the futures it was
    serving and on the queued ones; later submits and ``stop`` raise."""
    gate = threading.Event()

    def step(x):
        assert gate.wait(timeout=WAIT_S)
        raise ValueError("step failed")
    sched = tcont.ContinuousScheduler(step, max_bucket=8, min_bucket=8)
    sched.start()
    first = sched.submit(_payload(0, 8))
    queued = sched.submit(_payload(1, 8))
    gate.set()
    for req in (first, queued):
        with pytest.raises(ValueError, match="step failed"):
            req.future.result(timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="serving loop failed"):
        sched.submit(_payload(2, 8))
    with pytest.raises(RuntimeError, match="serving loop failed"):
        sched.stop()
    assert sched._thread is None


# ---------------------------------------------------------------------------
# estimator and straggler monitor
# ---------------------------------------------------------------------------

def _estimator_trace(backends):
    est = backends.StepTimeEstimator(alpha=0.3)
    out = [est.estimate(8)]
    est.seed(256, 0.004)
    est.seed(64, 0.002)
    for b in (8, 64, 128, 256, 512):
        out.append(est.estimate(b))
    rng = np.random.default_rng(3)
    for _ in range(40):
        b = int(2 ** rng.integers(3, 9))
        est.update(b, float(rng.uniform(1e-4, 5e-3)))
        out.append([est.estimate(q) for q in (8, 16, 32, 64, 128, 256, 512)])
    out.append(est.snapshot())
    out.append(est.updates)
    auto = types.SimpleNamespace(
        timings={8: {"fused-packed": 1e-4, "packed-eager": 3e-4},
                 16: {"fused-packed": 2e-4, "float-oracle": 1e-4},
                 32: {"packed-eager": 5e-4}},
        choice={8: "fused-packed", 16: "float-oracle", 32: "fused-packed"})
    cal = backends.estimator_from_calibration(auto)
    out.append([cal.estimate(b) for b in (8, 16, 32, 64)])
    out.append(cal.snapshot())
    return out


def test_step_time_estimator_equals_the_reference():
    """Exact: seeds, EWMA updates, the larger-bucket fallback, the
    snapshot and the calibration seeding (a bucket whose choice was not
    timed gets no seed)."""
    assert _estimator_trace(tbackends) == _estimator_trace(jbackends)


def _straggler_trace(mod):
    actions = []
    mon = mod.StragglerMonitor(window=24, z_threshold=3.0, patience=2,
                               min_samples=8, action=actions.append)
    rng = np.random.default_rng(11)
    times = ([0.0] * 10                                   # zero median
             + [0.004] * 12                               # constant window
             + list(0.004 + rng.normal(0, 2e-4, 40))      # jitter
             + [0.02, 0.03, 0.004, 0.05, 0.05, 0.05]      # outliers
             + list(0.006 + rng.normal(0, 1e-4, 30)))     # a slower level
    out = []
    for t in times:
        before = mon.threshold_s()
        ev = mon.report(float(t))
        out.append((before, None if ev is None else
                    (ev.step, ev.step_time_s, ev.median_s, ev.mad_s, ev.z)))
    out.append([(e.step, e.z) for e in mon.events])
    out.append([(e.step, e.z) for e in actions])
    out.append((list(mon.times), mon.consecutive, mon.threshold_s()))
    return out


def test_straggler_monitor_equals_the_reference():
    """Exact: the same flagged steps and z, threshold_s before every
    report, actions after ``patience`` flags, and the window (flagged
    steps kept out of it)."""
    port, ref = _straggler_trace(tstraggler), _straggler_trace(jstraggler)
    assert port == ref
    assert port[-3], "the sequence flags no step"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

N_TRAIN = 800
#: ragged and oversize (max_bucket 32) request sizes
SIZES = (5, 17, 32, 100, 3, 1, 64, 9)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The reference fits dwn-jsc-sm and saves it; the port loads it onto
    the CPU.  Both engines serve the packed datapath without a tuner."""
    spec = jget_spec("dwn-jsc-sm")
    data = load_workload(spec.workload, N_TRAIN, 512, seed=0)
    jart = JArtifact(spec).fit(data.x_train, seed=0).freeze().pack()
    path = tmp_path_factory.mktemp("sm_ckpt")
    jart.save(path)
    port = ServingEngine(DWNArtifact.load(path, device="cpu"),
                         device="cpu", backend="packed-eager",
                         max_bucket=32, min_bucket=8, n_train=N_TRAIN)
    ref = JEngine(jart, max_bucket=32, min_bucket=8, n_train=N_TRAIN,
                  backend="packed-xla", verify=False)
    return port, ref


def test_async_equals_sync_and_the_reference_engine(engines):
    """Exact: ragged and oversize payloads through the port's ``serve()``
    / ``submit_async`` equal its sync drain and the reference engine's
    ``submit_async`` results, counts and predictions element for
    element; the session's counters and report agree."""
    port, ref = engines
    payloads = [port.make_request(n, seed=i) for i, n in enumerate(SIZES)]
    for p in payloads:
        port.submit(p)
    sync = sorted(port.drain(), key=lambda r: r.rid)
    before = port.report()
    with port.serve():
        reqs = [port.submit_async(p) for p in payloads]
        results = [r.future.result(timeout=WAIT_S) for r in reqs]
    with ref.serve():
        jreqs = [ref.submit_async(p) for p in payloads]
        jresults = [r.future.result(timeout=WAIT_S) for r in jreqs]
    for res, jres, s, n in zip(results, jresults, sync, SIZES):
        assert res.ok and res.shed is None and jres.ok
        assert s.size == n and res.value[0].shape[0] == n
        for got, want, jwant in zip(res.value, s.result, jres.value):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, np.asarray(jwant))
    rep = port.report()
    assert rep["shed"]["requests"] == 0
    assert rep["async"]["served_requests"] == len(SIZES)
    assert rep["async"]["served_samples"] == sum(SIZES)
    assert rep["served"] == before["served"] + sum(SIZES)
    assert rep["async"]["steps"] >= -(-sum(SIZES) // 32)
    assert rep["straggler"]["window"] > 0
    assert 32 in rep["async"]["step_estimates_ms"]
    assert set(rep["async"]["step_estimates_ms"]) <= {8, 16, 32}
    assert port.compile_counts()["packed-eager"].keys() <= {8, 16, 32}


def test_slo_invariant_under_saturation_on_an_injected_clock(engines,
                                                             monkeypatch):
    """Deterministic: the port's loop over the engine's DWN step, on a
    clock each step advances by 1 ms and each submit by 0.1 ms, with
    3 ms deadlines and three requests of 4 x max_bucket rows at 0.5 ms.
    Every ok result is on time and equal to the float oracle, something
    is shed or rejected, and ``report()`` agrees with the results."""
    port, _ = engines
    clock = FakeClock()
    step = port._dwn_step

    def stepping(x):
        clock.advance(1e-3)
        return step(x)
    monkeypatch.setattr(port, "_dwn_step", stepping)
    monkeypatch.setattr(port, "estimator", tbackends.StepTimeEstimator())
    port.estimator.seed(port.scheduler.max_bucket, 1e-3)
    before = port.report()
    sched = port._continuous(tcont.SLOConfig(max_queue_samples=128,
                                             submit_timeout_s=0.0),
                             timer=clock)
    rng = np.random.default_rng(7)
    plan = [(int(rng.integers(1, 33)), 3.0) for _ in range(120)]
    plan[40:40] = [(4 * port.scheduler.max_bucket, 0.5)] * 3
    reqs, rejected = [], 0
    for i, (n, deadline_ms) in enumerate(plan):
        try:
            reqs.append(sched.submit(port.make_request(n, seed=i),
                                     deadline_ms=deadline_ms))
        except tcont.QueueFull:
            rejected += 1
        clock.advance(1e-4)
        if i % 3 == 2:
            sched.step_once()
    while sched.pending:
        sched.step_once()
    results = [r.future.result(timeout=WAIT_S) for r in reqs]
    port._end_session(sched)

    assert len(results) + rejected == len(plan)
    oracle = port.backends["float-oracle"]
    for req, res in zip(reqs, results):
        assert res.shed in (None, tcont.SHED_ADMISSION, tcont.SHED_EXPIRED,
                            tcont.SHED_LATE)
        if res.ok:
            assert req.t_done <= req.deadline
            counts, pred = oracle(torch.from_numpy(
                np.ascontiguousarray(req.payload, np.float32)))
            np.testing.assert_array_equal(res.value[0], counts.numpy())
            np.testing.assert_array_equal(res.value[1], pred.numpy())
        else:
            assert res.value is None or res.shed == tcont.SHED_LATE
    not_ok = sum(1 for r in results if not r.ok)
    assert rejected + not_ok > 0
    assert any(r.ok for r in results)
    rep = port.report()
    assert rep["shed"]["requests"] - before["shed"]["requests"] == not_ok
    assert set(rep["shed"]["by_reason"]) <= {
        tcont.SHED_ADMISSION, tcont.SHED_EXPIRED, tcont.SHED_LATE}
    assert rep["async"]["steps"] == sched.steps > 0
    assert rep["async"]["shed_requests"] == not_ok


def test_async_api_needs_a_session_and_the_dwn_family(engines):
    """``submit_async`` outside a session, a second session and stopping
    without one raise."""
    port, _ = engines
    with pytest.raises(RuntimeError, match="serving loop"):
        port.submit_async(port.make_request(4))
    with pytest.raises(RuntimeError, match="not running"):
        port.stop_serving()
    with port.serve():
        with pytest.raises(RuntimeError, match="already running"):
            port.start_serving()


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------

def test_recording_holds_only_its_own_threads_launches():
    """A recording open in one thread (a graph capture) takes none of the
    launches another thread counts meanwhile (a replay)."""
    counts = _launch.LaunchCounts("k", "zero")
    opened, counted = threading.Event(), threading.Event()
    recorded = []

    def capture():
        with _launch.recording() as rec:
            counts.add("zero")
            opened.set()
            assert counted.wait(timeout=WAIT_S)
        recorded.extend(rec)

    t = threading.Thread(target=capture)
    t.start()
    assert opened.wait(timeout=WAIT_S)
    counts.add("k", 3)
    counted.set()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert counts.get() == {"k": 3, "zero": 0}
    assert [(name, n) for _, name, n in recorded] == [("zero", 1)]


def test_concurrent_launch_counts_are_not_lost():
    """Sixteen threads add at once under a short switch interval; the
    counts are exact."""
    counts = _launch.LaunchCounts("k")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counts.add("k") for _ in range(5000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert counts.get() == {"k": 16 * 5000}
