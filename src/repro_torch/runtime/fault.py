"""Fault tolerance: restart supervisor + preemption handling.

The port's copy of the reference's ``repro.runtime.fault``, over the
port's ``runtime.checkpoint`` (the reference's on-disk layout).  Where the
reference restores a checkpoint onto ``shardings``, the port's
``Supervisor`` restores its leaves as tensors on ``device``: by default
the device of ``init_state``'s tensors, so a run on the card resumes on
the card; with no tensor there, the card (``resolve_device``).  Pass
``device="cpu"`` to restore on the CPU.  The port's train steps update
their state in place, so ``Supervisor.run`` also takes ``init_state`` as
a callable that makes the step-0 state: a restart that finds no
checkpoint then starts from a fresh one, where a state passed as a value
would already hold the steps run before the crash.

At datacenter scale the failure domains are: worker process crash, node
loss (checkpoint/restart), and preemption notice (drain + final
checkpoint).  This module implements the control logic in-process so it
is testable on CPU; the same supervisor wraps the per-host launcher in a
real deployment.

* ``Supervisor.run(step_fn, ...)`` drives the training loop, catches
  worker exceptions, restores from the latest committed checkpoint and
  resumes, with bounded restarts within a sliding window (a crash loop
  aborts rather than burning the cluster);
* ``PreemptionHandler`` converts SIGTERM into a cooperative "save and
  exit" at the next step boundary (the preemption notice of a cloud
  instance);
* injected failures are used by tests (``FaultInjector``).
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Callable

import torch

from ..device import resolve_device
from . import checkpoint as ckpt

logger = logging.getLogger(__name__)


class PreemptionHandler:
    """SIGTERM -> drain at the next step boundary.

    ``register`` is the signal-installation function (default
    ``signal.signal``) — injectable so tests cover both the installed
    path and the off-main-thread fallback without touching process
    signal state.  When installation fails (``signal.signal`` raises
    ``ValueError`` off the main thread), the handler degrades to a
    cooperative flag: ``installed`` stays False, the fallback is
    *logged* (not silent), and callers may still set ``requested``
    directly.
    """

    def __init__(self, install: bool = True, *, register=None,
                 signum: int = signal.SIGTERM):
        self.requested = False
        self.installed = False
        self.signum = signum
        if install:
            register = register or signal.signal
            try:
                register(signum, self._on_signal)
                self.installed = True
            except ValueError:                   # non-main thread
                logger.warning(
                    "cannot install signal %d handler off the main thread; "
                    "falling back to the cooperative `requested` flag",
                    signum)

    def _on_signal(self, signum, frame):
        logger.warning("preemption signal received; draining")
        self.requested = True


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    window_s: float = 3600.0                     # sliding window
    backoff_s: float = 1.0


@dataclasses.dataclass
class TrainHandle:
    """What the supervised step function operates on."""
    state: object                                # (params, opt_state, ...)
    step: int
    extra: dict


class Supervisor:
    """Checkpoint-restart supervisor around a step function.

    step_fn(handle) -> handle  advances exactly one optimizer step and
    may raise; save_every controls checkpoint cadence.
    """

    def __init__(self, ckpt_dir: str, *, policy: RestartPolicy | None = None,
                 save_every: int = 50, keep: int = 3,
                 preemption: PreemptionHandler | None = None,
                 device=None):
        self.ckpt_dir = ckpt_dir
        self.policy = policy or RestartPolicy()
        self.save_every = save_every
        self.keep = keep
        self.preemption = preemption or PreemptionHandler(install=False)
        self.device = device
        self.restart_times: list[float] = []
        self.restarts = 0

    # -- state management -------------------------------------------------

    def _state_device(self, init_state) -> torch.device:
        """``self.device`` if given, else that of ``init_state``'s first
        tensor leaf, else the card."""
        if self.device is not None:
            return resolve_device(self.device)
        for _, leaf in ckpt._leaf_paths(init_state):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
        return resolve_device(None)

    def _restore_or(self, init_state, init_extra) -> TrainHandle:
        state = init_state() if callable(init_state) else init_state
        step, tree, extra = ckpt.restore_latest(
            self.ckpt_dir, state, device=self._state_device(state))
        if step is None:
            return TrainHandle(state, 0, dict(init_extra))
        del state
        logger.info("restored checkpoint step %d", step)
        return TrainHandle(tree, step, extra or {})

    def _save(self, handle: TrainHandle) -> None:
        ckpt.save(self.ckpt_dir, handle.step, handle.state,
                  extra=handle.extra)
        ckpt.garbage_collect(self.ckpt_dir, keep=self.keep)

    def _register_crash(self) -> bool:
        """True if the restart budget allows another attempt."""
        now = time.time()
        self.restart_times = [t for t in self.restart_times
                              if now - t < self.policy.window_s]
        self.restart_times.append(now)
        self.restarts += 1
        return len(self.restart_times) <= self.policy.max_restarts

    # -- main loop ----------------------------------------------------------

    def run(self, step_fn: Callable[[TrainHandle], TrainHandle], *,
            init_state, total_steps: int, init_extra: dict | None = None,
            on_step=None) -> TrainHandle:
        handle = self._restore_or(init_state, init_extra or {})
        while handle.step < total_steps:
            if self.preemption.requested:
                logger.warning("draining at step %d", handle.step)
                self._save(handle)
                return handle
            try:
                handle = step_fn(handle)
            except Exception:
                logger.exception("worker failure at step %d", handle.step)
                if not self._register_crash():
                    logger.error("restart budget exhausted; aborting")
                    raise
                time.sleep(self.policy.backoff_s)
                handle = None            # the failed state, before a new one
                handle = self._restore_or(init_state, init_extra or {})
                continue
            if handle.step % self.save_every == 0:
                self._save(handle)
            if on_step:
                on_step(handle)
        self._save(handle)
        return handle

    # -- supervised unit of work -------------------------------------------

    def supervise(self, fn: Callable[[], object], *,
                  label: str = "task", on_retry=None):
        """Run an arbitrary callable under the restart policy.

        The checkpointed ``run`` loop above supervises a *step function*;
        ``supervise`` is the same bounded-restart control logic for a
        one-shot unit of work whose durable state lives elsewhere (e.g. a
        sweep grid point, persisted through the result cache + artifact
        store rather than a step checkpoint).  Retries ``fn`` with
        backoff until it returns; when the restart budget is exhausted
        the last exception propagates to the caller.
        """
        while True:
            try:
                return fn()
            except Exception:
                logger.exception("supervised %s failed", label)
                if not self._register_crash():
                    logger.error("restart budget exhausted for %s", label)
                    raise
                if on_retry:
                    on_retry(self.restarts)
                time.sleep(self.policy.backoff_s)


class FaultInjector:
    """Deterministic crash injection for tests: raises on given steps.

    ``every_step=True`` makes the injector fire on *every* visit to a
    crash step, not just the first — the crash-loop shape a bounded
    ``RestartPolicy`` must abort on instead of spinning forever.
    """

    def __init__(self, crash_steps: set[int], *, every_step: bool = False):
        self.crash_steps = set(crash_steps)
        self.every_step = every_step
        self.crashed: set[int] = set()
        self.fired = 0

    def maybe_crash(self, step: int):
        if step in self.crash_steps and (self.every_step
                                         or step not in self.crashed):
            self.crashed.add(step)
            self.fired += 1
            raise RuntimeError(f"injected fault at step {step}")
