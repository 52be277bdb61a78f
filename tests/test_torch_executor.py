"""The port's resilient sweep executor (``repro_torch.sweep.executor``)
and its restart supervisor (``repro_torch.runtime.fault``), on the CPU.

The reference's executor tests, ported: parallel equals serial, resume
with zero recomputed points, the executor block's JSON, chaos-driven
worker deaths, a crash loop, one failed point, in-worker retries,
straggler speculation (asserted on the executor's counters and log, never
on wall time), preemption before the start and mid-run, and per-point
artifacts that load back through ``DWNArtifact.load``.  Then the
reference's fault-tolerance tests of ``tests/test_runtime.py`` over the
port's checkpoints, a supervised run with injected crashes held to the
reference's.

Worker processes are spawned (each imports torch afresh, with one
thread), so settings stay minimal (no kernel or serve axes, tiny splits).
"""

import json
import logging
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.runtime import fault as jfault  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime import fault as tfault  # noqa: E402
from repro_torch.runtime.fault import (FaultInjector,  # noqa: E402
                                       PreemptionHandler, RestartPolicy,
                                       Supervisor, TrainHandle)
from repro_torch.sweep import (SweepPoint, SweepResult,  # noqa: E402
                               SweepSettings, run_grid)
from repro_torch.sweep.executor import (ChaosSpec,  # noqa: E402
                                        ExecutorSettings,
                                        run_grid_parallel)

FAST = SweepSettings(n_train=256, n_test=128, accuracy=False,
                     kernel=False, serve=False, device="cpu")

POINTS = [SweepPoint("sm-10", "TEN"),
          SweepPoint("sm-10", "PEN", input_bits=4),
          SweepPoint("sm-50", "TEN"),
          SweepPoint("sm-50", "PEN", input_bits=4)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the suite runs timing-bound
    reference tests in parallel workers beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Spawned workers inherit one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _labels(result):
    return [r.point.label for r in result.points]


# ---------------------------------------------------------------------------
# parity + resume
# ---------------------------------------------------------------------------

def test_parallel_matches_serial(tmp_path):
    """Same grid through both executors: identical hardware numbers and
    accuracies, plus the executor provenance block."""
    settings = SweepSettings(n_train=256, n_test=128, accuracy=True,
                             kernel=False, serve=False, device="cpu")
    pts = POINTS[:2]
    serial = run_grid(pts, settings, cache_dir=None)
    par = run_grid_parallel(pts, settings, cache_dir=tmp_path / "c",
                            executor=ExecutorSettings(workers=2))
    assert _labels(par) == _labels(serial)
    for a, b in zip(par.points, serial.points):
        assert a.total_luts == b.total_luts
        assert a.luts == b.luts and a.total_ffs == b.total_ffs
        assert a.accuracy == b.accuracy
        assert not a.failed
    assert par.executor["mode"] == "parallel"
    assert par.executor["computed"] == 2
    assert par.executor["failed"] == []
    assert serial.executor["mode"] == "serial"


def test_resume_zero_recomputed_points(tmp_path):
    """A completed run re-runs entirely from the cache — zero computed
    points — and the serial runner resumes from the same cache."""
    first = run_grid_parallel(POINTS, FAST, cache_dir=tmp_path,
                              executor=ExecutorSettings(workers=2))
    assert first.executor["computed"] == len(POINTS)
    again = run_grid_parallel(POINTS, FAST, cache_dir=tmp_path,
                              executor=ExecutorSettings(workers=2))
    assert again.executor["computed"] == 0
    assert again.executor["cache_hits"] == len(POINTS)
    assert all(r.cached for r in again.points)
    serial = run_grid(POINTS, FAST, cache_dir=tmp_path)
    assert serial.executor["computed"] == 0
    assert serial.executor["cache_hits"] == len(POINTS)


def test_executor_block_json_roundtrip(tmp_path):
    res = run_grid_parallel(POINTS[:1], FAST, cache_dir=None,
                            executor=ExecutorSettings(workers=1))
    f = tmp_path / "sweep.json"
    res.save(f)
    loaded = SweepResult.load(f)
    assert loaded.executor == res.executor
    assert json.loads(f.read_text())["executor"]["mode"] == "parallel"


# ---------------------------------------------------------------------------
# chaos: worker death, crash loop, per-point failure
# ---------------------------------------------------------------------------

def test_chaos_worker_kill_run_survives(tmp_path):
    """Every worker hard-exits after each completed point: the dispatcher
    respawns workers and the grid completes with no failed and no
    recomputed points."""
    res = run_grid_parallel(
        POINTS, FAST, cache_dir=tmp_path,
        executor=ExecutorSettings(workers=1, chaos="kill-after-1"))
    assert res.executor["computed"] == len(POINTS)
    assert res.executor["failed"] == []
    assert res.executor["worker_deaths"] >= len(POINTS) - 1
    assert res.executor["workers_spawned"] >= len(POINTS) - 1
    again = run_grid_parallel(POINTS, FAST, cache_dir=tmp_path,
                              executor=ExecutorSettings(workers=1))
    assert again.executor["computed"] == 0
    assert again.executor["cache_hits"] == len(POINTS)


def test_chaos_crash_loop_fails_points_without_spinning(tmp_path):
    """raise-always: each point exhausts its bounded restart budget and is
    reported failed; the run terminates instead of spinning."""
    res = run_grid_parallel(
        POINTS[:2], FAST, cache_dir=tmp_path,
        executor=ExecutorSettings(workers=1, chaos="raise-always",
                                  max_restarts=1))
    assert len(res.points) == 2
    assert all(r.failed and r.error for r in res.points)
    assert sorted(res.executor["failed"]) == sorted(_labels(res))
    # max_restarts=1 -> exactly 2 attempts per point, 1 retry each
    assert res.executor["in_worker_retries"] == 2


def test_chaos_one_failed_point_does_not_abort_grid(tmp_path):
    """A single persistently failing point is reported failed; the rest
    of the grid completes and caches normally."""
    res = run_grid_parallel(
        POINTS, FAST, cache_dir=tmp_path,
        executor=ExecutorSettings(workers=2, chaos="raise-point-0",
                                  max_restarts=1))
    by = {r.point.label: r for r in res.points}
    assert by[POINTS[0].label].failed
    assert "injected persistent fault" in by[POINTS[0].label].error
    ok = [r for r in res.points if not r.failed]
    assert len(ok) == len(POINTS) - 1
    assert res.executor["failed"] == [POINTS[0].label]
    assert "FAILED" in res.table()
    again = run_grid_parallel(POINTS, FAST, cache_dir=tmp_path,
                              executor=ExecutorSettings(workers=2))
    assert again.executor["cache_hits"] == len(POINTS) - 1
    assert again.executor["computed"] == 1
    assert not any(r.failed for r in again.points)


def test_chaos_raise_after_exercises_in_worker_retry(tmp_path):
    """raise-after-N fires once per worker; the in-worker Supervisor
    retries and the point still completes (no parent-side restart)."""
    res = run_grid_parallel(
        POINTS[:2], FAST, cache_dir=tmp_path,
        executor=ExecutorSettings(workers=1, chaos="raise-after-1"))
    assert res.executor["computed"] == 2
    assert res.executor["failed"] == []
    assert res.executor["in_worker_retries"] == 1
    assert res.executor["restarts"] == 0


def test_chaos_spec_parsing():
    assert ChaosSpec.parse(None) == ChaosSpec()
    assert ChaosSpec.parse("kill-after-3").kill_after == 3
    assert ChaosSpec.parse("raise-after-1").raise_after == 1
    assert ChaosSpec.parse("raise-always").raise_always
    assert ChaosSpec.parse("raise-point-2").raise_point == 2
    s = ChaosSpec.parse("stall-0:2.5")
    assert s.stall_index == 0 and s.stall_s == 2.5
    with pytest.raises(ValueError, match="unknown chaos"):
        ChaosSpec.parse("set-fire-to-rack")
    with pytest.raises(ValueError):
        run_grid_parallel(POINTS[:1], FAST, cache_dir=None,
                          executor=ExecutorSettings(chaos="bogus"))


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

def test_straggler_speculative_redispatch(tmp_path):
    """A stalled first attempt is flagged against the robust-z threshold
    of completed-point wall times and speculatively re-dispatched to a
    fresh worker; the fresh attempt wins.  Asserted on the executor's
    counters and its log, not on wall time."""
    pts = [SweepPoint("sm-10", "TEN")] + \
          [SweepPoint("sm-10", "PEN", input_bits=b) for b in range(4, 9)]
    lines = []
    res = run_grid_parallel(
        pts, FAST, cache_dir=tmp_path,
        executor=ExecutorSettings(workers=2, chaos="stall-0:600",
                                  straggler_min_samples=3),
        log=lines.append)
    assert res.executor["stragglers_redispatched"] >= 1
    assert res.executor["failed"] == []
    assert len([r for r in res.points if not r.failed]) == len(pts)
    assert any(l.startswith(f"straggler: {pts[0].label}") for l in lines)
    # the stalled point was won by its re-dispatch, never by the stall
    assert any(pts[0].label in l and "attempt 2" in l for l in lines)
    assert res.executor["workers_spawned"] >= 3


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_preemption_before_start_interrupts_resumably(tmp_path):
    pre = PreemptionHandler(install=False)
    pre.requested = True
    res = run_grid_parallel(POINTS, FAST, cache_dir=tmp_path,
                            executor=ExecutorSettings(workers=2),
                            preemption=pre)
    assert res.executor["interrupted"]
    assert res.executor["remaining"] == len(POINTS)
    assert res.executor["remaining_points"] == [p.label for p in POINTS]
    assert res.points == []


def test_preemption_mid_run_drains_and_resumes(tmp_path):
    """Preemption requested while the grid is in flight: the run stops
    early but every completed point is cached, so the follow-up run
    computes exactly the complement — zero recomputed points."""
    pre = PreemptionHandler(install=False)
    t = threading.Timer(2.0, lambda: setattr(pre, "requested", True))
    t.start()
    try:
        first = run_grid_parallel(POINTS, FAST, cache_dir=tmp_path,
                                  executor=ExecutorSettings(workers=1),
                                  preemption=pre)
    finally:
        t.cancel()
    done = first.executor["computed"]
    resumed = run_grid_parallel(POINTS, FAST, cache_dir=tmp_path,
                                executor=ExecutorSettings(workers=1))
    assert resumed.executor["cache_hits"] == done
    assert resumed.executor["computed"] == len(POINTS) - done
    assert len(resumed.points) == len(POINTS)
    assert not any(r.failed for r in resumed.points)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def test_executor_persists_point_artifacts(tmp_path):
    """Every computed point checkpoints as a packed DWNArtifact that loads
    back through ``DWNArtifact.load`` and freezes to the same cost."""
    from repro_torch.dwn import DWNArtifact
    adir = tmp_path / "artifacts"
    res = run_grid_parallel(
        POINTS[:2], FAST, cache_dir=tmp_path / "c",
        executor=ExecutorSettings(workers=2, artifact_dir=str(adir)))
    assert res.executor["computed"] == 2
    subdirs = sorted(p for p in adir.iterdir() if p.is_dir())
    assert len(subdirs) == 2
    by = {r.point.label.replace("/", "_").replace("@", ""): r
          for r in res.points}
    for d in subdirs:
        art = DWNArtifact.load(d, device="cpu")
        assert art.stage == "packed" and art.packed.device.type == "cpu"
        r = by[d.name.rsplit("-", 1)[0]]
        assert art.spec.label == r.point.label
        assert art.hw_report().total_luts == r.total_luts


def test_serial_run_persists_artifacts(tmp_path):
    """``run_grid(artifact_dir=...)`` checkpoints every computed point the
    same way, and not the cached ones."""
    from repro_torch.dwn import DWNArtifact
    adir = tmp_path / "a"
    run_grid(POINTS[:1], FAST, cache_dir=tmp_path / "c",
             artifact_dir=str(adir))
    run_grid(POINTS[:1], FAST, cache_dir=tmp_path / "c",
             artifact_dir=str(tmp_path / "b"))
    (d,) = adir.iterdir()
    assert DWNArtifact.load(d, device="cpu").spec.label == POINTS[0].label
    assert not (tmp_path / "b").exists()


# ---------------------------------------------------------------------------
# runtime.fault: the supervisor over the port's checkpoints
# ---------------------------------------------------------------------------

def _counting_step(inj, record=None, stop=None):
    def step(handle: TrainHandle) -> TrainHandle:
        if record is not None:
            record.append(handle.step)
        inj.maybe_crash(handle.step)
        handle.state = {"w": handle.state["w"] + 1.0}
        handle.step += 1
        if stop is not None and handle.step == stop[0]:
            stop[1].requested = True
        return handle
    return step


def test_supervisor_crash_resume_equals_clean_run_and_reference(tmp_path):
    """Crashes at injected steps: the final state equals the
    uninterrupted run's, with the reference's restart count and state."""

    def run(fault, zeros, crash_steps, d):
        inj = fault.FaultInjector(crash_steps)

        def step(handle):
            inj.maybe_crash(handle.step)
            handle.state = {"w": handle.state["w"] + 1.0}
            handle.step += 1
            return handle
        sup = fault.Supervisor(str(d), save_every=2,
                               policy=fault.RestartPolicy(max_restarts=10,
                                                          backoff_s=0))
        h = sup.run(step, init_state={"w": zeros(2)}, total_steps=9)
        return np.asarray(h.state["w"]), h.step, sup.restarts

    w_clean, s_clean, _ = run(tfault, torch.zeros, set(), tmp_path / "clean")
    w_faulty, s_faulty, restarts = run(tfault, torch.zeros, {3, 7},
                                       tmp_path / "faulty")
    jw, js, jrestarts = run(jfault, jnp.zeros, {3, 7}, tmp_path / "ref")
    assert restarts == jrestarts == 2
    assert s_clean == s_faulty == js == 9
    np.testing.assert_array_equal(w_clean, w_faulty)
    np.testing.assert_array_equal(w_faulty, jw)


def test_supervisor_restart_budget(tmp_path):
    def step(handle):
        raise RuntimeError("always broken")

    sup = Supervisor(str(tmp_path), save_every=2,
                     policy=RestartPolicy(max_restarts=2, backoff_s=0))
    with pytest.raises(RuntimeError):
        sup.run(step, init_state={"w": torch.zeros(1)}, total_steps=5)
    assert sup.restarts == 3        # 2 allowed + the aborting one


def test_supervisor_preemption_drains(tmp_path):
    pre = PreemptionHandler(install=False)
    sup = Supervisor(str(tmp_path), save_every=100, preemption=pre)
    h = sup.run(_counting_step(FaultInjector(set()), stop=(4, pre)),
                init_state={"w": torch.zeros(1)}, total_steps=50)
    assert h.step == 4
    assert ckpt.latest_step(tmp_path) == 4    # drained with a checkpoint


def test_preemption_handler_injectable_register():
    calls = []
    pre = PreemptionHandler(register=lambda s, h: calls.append((s, h)),
                            signum=15)
    assert pre.installed
    assert calls == [(15, pre._on_signal)]
    pre._on_signal(15, None)
    assert pre.requested


def test_preemption_handler_fallback_logged(caplog):
    """Off the main thread signal.signal raises ValueError; the handler
    degrades to the cooperative flag and logs the fallback."""
    def register(signum, handler):
        raise ValueError("signal only works in main thread")

    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.runtime.fault"):
        pre = PreemptionHandler(register=register)
    assert not pre.installed
    assert any("falling back" in r.message for r in caplog.records)
    pre.requested = True
    assert pre.requested


def test_supervisor_crash_loop_aborts_not_spins(tmp_path):
    """A fault firing on every visit to the same step is a crash loop:
    the bounded RestartPolicy aborts after max_restarts."""
    inj = FaultInjector({3}, every_step=True)
    steps_run = []

    def step(handle):
        inj.maybe_crash(handle.step)
        steps_run.append(handle.step)
        handle.state = {"w": handle.state["w"] + 1}
        handle.step += 1
        return handle

    sup = Supervisor(str(tmp_path), save_every=2,
                     policy=RestartPolicy(max_restarts=3, backoff_s=0))
    with pytest.raises(RuntimeError, match="injected fault at step 3"):
        sup.run(step, init_state={"w": torch.zeros(1)}, total_steps=9)
    assert inj.fired == 4                      # 3 retries + aborting attempt
    assert sup.restarts == 4
    assert max(steps_run) == 2


def test_supervisor_resumes_from_latest_committed_checkpoint(tmp_path):
    """A transient fault restores from the latest committed checkpoint
    (step 4 with save_every=2 when crashing at step 5), as tensors."""
    resumed_from = []
    sup = Supervisor(str(tmp_path), save_every=2,
                     policy=RestartPolicy(max_restarts=2, backoff_s=0))
    h = sup.run(_counting_step(FaultInjector({5}), record=resumed_from),
                init_state={"w": torch.zeros(1)}, total_steps=8)
    assert h.step == 8
    assert isinstance(h.state["w"], torch.Tensor)
    assert float(h.state["w"][0]) == 8.0
    i = resumed_from.index(5)
    assert resumed_from[i + 1] == 4


def test_supervisor_restores_onto_the_state_device(tmp_path, monkeypatch):
    """A restart restores onto the device of ``init_state``'s tensors by
    default; a state without tensors restores onto the card, which raises
    without one; ``device="cpu"`` restores on the CPU."""
    sup = Supervisor(str(tmp_path))
    assert sup._state_device({"w": torch.zeros(1)}) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sup._state_device({"w": np.zeros(1)})
    cpu = Supervisor(str(tmp_path), save_every=2, device="cpu",
                     policy=RestartPolicy(max_restarts=2, backoff_s=0))
    h = cpu.run(_counting_step(FaultInjector({3})),
                init_state={"w": np.zeros(1, np.float32)}, total_steps=5)
    assert cpu.restarts == 1 and h.step == 5
    assert isinstance(h.state["w"], torch.Tensor)
    assert h.state["w"].device.type == "cpu" and float(h.state["w"][0]) == 5


def test_supervise_retries_transient_then_succeeds(tmp_path):
    attempts, retries = [], []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    sup = Supervisor(str(tmp_path),
                     policy=RestartPolicy(max_restarts=5, backoff_s=0))
    assert sup.supervise(flaky, label="unit", on_retry=retries.append) \
        == "ok"
    assert len(attempts) == 3
    assert retries == [1, 2]
    assert sup.restarts == 2


def test_supervise_budget_exhausted_raises(tmp_path):
    n = [0]

    def broken():
        n[0] += 1
        raise ValueError("always broken")

    sup = Supervisor(str(tmp_path),
                     policy=RestartPolicy(max_restarts=2, backoff_s=0))
    with pytest.raises(ValueError, match="always broken"):
        sup.supervise(broken)
    assert n[0] == 3                           # bounded: 1 + max_restarts
