#!/usr/bin/env python3
"""What a continuous-batching step costs the loop thread, on one CUDA card.

Serves dwn-jsc-lg pinned to K2 (max_bucket 4096) and times its step of
4096 rows five ways, in turns, twice: the engine's step called in a loop
from the main thread (the bare step); the ``ContinuousScheduler`` loop
thread over 200 requests of 4096 rows queued up front while the main
thread sleeps until they are served; the same while the main thread waits
on each request's future in turn; the same with Python's garbage
collector off; and the loop while a second thread runs Python without
pause (an open-loop producer that is behind its schedule) under the load
generator's 0.5 ms switch interval.  Each case prints the loop's mean
step ms (its ``busy_s`` over its steps, the time admission control
learns) and the wall ms a step.  Prints one JSON line and the card's name
and power limit.

    python3 scripts/loop_ab.py
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

REQUESTS = 200
ROWS = 4096


def _bare(engine, x, n=REQUESTS):
    t0 = time.perf_counter()
    for _ in range(n):
        engine._dwn_step(x)
    ms = (time.perf_counter() - t0) / n * 1e3
    return {"mean_step_ms": ms, "wall_ms_per_step": ms}


def _loop(engine, x, wait):
    from repro_torch.serving import ContinuousScheduler, SLOConfig
    sched = ContinuousScheduler(engine._dwn_step, max_bucket=ROWS,
                                min_bucket=8,
                                slo=SLOConfig(max_queue_samples=1 << 24))
    reqs = [sched.submit(x) for _ in range(REQUESTS)]
    spinning = threading.Event()

    def spin():
        n = 0
        while spinning.is_set():
            n += 1
    spinner = threading.Thread(target=spin)
    switch = sys.getswitchinterval()
    if wait == "producer":
        sys.setswitchinterval(0.0005)
        spinning.set()
        spinner.start()
    if wait == "futures, gc off":
        gc.disable()
    t0 = time.perf_counter()
    try:
        sched.start()
        if wait in ("futures", "futures, gc off"):
            for r in reqs:
                r.future.result(timeout=120)
        else:
            while not reqs[-1].future.done():
                time.sleep(0.01)
        wall = time.perf_counter() - t0
        sched.stop()
    finally:
        gc.enable()
        spinning.clear()
        if spinner.is_alive():
            spinner.join(timeout=60)
        sys.setswitchinterval(switch)
    if not all(r.future.result(timeout=0).ok for r in reqs):
        raise SystemExit(f"{wait}: a request was not served")
    return {"mean_step_ms": sched.busy_s / sched.steps * 1e3,
            "wall_ms_per_step": wall / sched.steps * 1e3,
            "steps": sched.steps}


CASES = {
    "bare step, main thread": lambda e, x: _bare(e, x),
    "loop, main sleeps": lambda e, x: _loop(e, x, "sleep"),
    "loop, main waits on each future": lambda e, x: _loop(e, x, "futures"),
    "loop, main waits on each future, gc off":
        lambda e, x: _loop(e, x, "futures, gc off"),
    "loop, a Python thread spins (0.5 ms switch)":
        lambda e, x: _loop(e, x, "producer"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("loop_ab: needs a CUDA card", file=sys.stderr)
        return 3
    from repro_torch.serving import ServingEngine
    engine = ServingEngine("dwn-jsc-lg", backend="fused-packed",
                           max_bucket=ROWS, n_train=2000)
    x = np.ascontiguousarray(engine.data.x_test[:ROWS], np.float32)
    for _ in range(20):
        engine._dwn_step(x)
    runs = {name: [] for name in CASES}
    for _ in range(2):
        for name, case in CASES.items():
            runs[name].append(case(engine, x))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"loop_ab": runs, "rows": ROWS,
                      "requests": REQUESTS, "nvidia_smi": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
