"""Straggler detection: the port's own copy of the reference's
``repro.runtime.straggler`` (pure Python).

The monitor keeps a ring buffer of per-step wall times and flags outliers
with a robust z-score (median/MAD); the configured action is invoked after
``patience`` consecutive flags.  The serving engine feeds it every DWN
step's wall time, from the sync drain and from the continuous-batching
loop, and reports its events.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time_s: float
    median_s: float
    mad_s: float
    z: float


class StragglerMonitor:
    def __init__(self, *, window: int = 64, z_threshold: float = 4.0,
                 patience: int = 3, min_samples: int = 16,
                 action: Callable[[StragglerEvent], None] | None = None):
        self.times: deque[float] = deque(maxlen=window)
        self.z_threshold = z_threshold
        self.patience = patience
        self.min_samples = min_samples
        self.action = action
        self.consecutive = 0
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None
        self._step = 0

    # -- timing interface ---------------------------------------------------

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self) -> StragglerEvent | None:
        assert self._t0 is not None, "step_start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.report(dt)

    def _baseline(self) -> tuple[float, float, float] | None:
        """(median, MAD, z-scale) of the window, or None below min_samples.

        The z-scale is floored at 5% of the median (and an absolute 1e-6):
        a *constant-time* window has MAD == 0, and without the floor the
        robust z would divide by ~zero and flag sub-percent jitter as a
        straggler (or, at median 0, divide by exactly zero).
        """
        if len(self.times) < self.min_samples:
            return None
        s = sorted(self.times)
        med = s[len(s) // 2]
        mad = sorted(abs(t - med) for t in s)[len(s) // 2]
        scale = max(1.4826 * mad, 1e-6, 0.05 * med)
        return med, mad, scale

    def threshold_s(self) -> float | None:
        """Wall time above which the *next* report would flag, or None
        while the window is below ``min_samples``.  Lets a dispatcher
        check *in-flight* work against the flag rule without waiting for
        the slow step to finish (speculative re-dispatch)."""
        base = self._baseline()
        if base is None:
            return None
        med, _, scale = base
        return med + self.z_threshold * scale

    def report(self, step_time_s: float) -> StragglerEvent | None:
        """Feed one step time; returns an event iff this step is flagged."""
        self._step += 1
        ev = None
        base = self._baseline()
        if base is not None:
            med, mad, scale = base
            z = (step_time_s - med) / scale
            if z > self.z_threshold:
                self.consecutive += 1
                ev = StragglerEvent(self._step, step_time_s, med, mad, z)
                self.events.append(ev)
                if self.action and self.consecutive >= self.patience:
                    self.action(ev)
                    self.consecutive = 0
            else:
                self.consecutive = 0
        # slow samples are *not* added to the window (they would poison
        # the baseline during a long degradation)
        if ev is None:
            self.times.append(step_time_s)
        return ev
