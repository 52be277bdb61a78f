#!/usr/bin/env python3
"""Stress the spawned gloo ranks of the data-parallel tests on the CPU.

``--target cont`` runs the CONT script of
``tests/test_torch_data_parallel.py`` (the continuous loop on a
data-parallel engine) as the tests spawn it, at worlds 2 and 4 each run;
``--no-exit`` drops its last lines (``EXIT``: leave with ``os._exit``)
so that the interpreter's teardown runs.  ``--target gloo`` runs a
script of ``torch.distributed`` alone, which imports nothing of the
port, shaped as CONT uses it: a gloo group, a ("data",) device mesh,
start-up all-gathers on the main thread, then four sessions of
broadcasts and all-gathers on a thread that is joined, the last without
its stop, then ``destroy_process_group``, at world 2.  Its ``--variant``
changes one thing: ``barrier`` (a barrier before the teardown),
``osexit`` (leave with ``os._exit`` after it), ``nothread`` (the sessions
on the main thread).

Runs ``--runs`` runs, ``--parallel`` at a time; keeps every rank's
stderr of a failing run under ``--out``; prints one JSON line a failing
spawn and a summary line.

    python3 scripts/dp_exit_stress.py --target gloo --runs 400
    python3 scripts/dp_exit_stress.py --target cont --runs 100
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

GLOO = """
import faulthandler, os, sys, threading
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
faulthandler.enable()
torch.set_num_threads(1)
rank, world, init, variant = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + init,
                        world_size=world, rank=rank)
g = init_device_mesh("cpu", (world,), mesh_dim_names=("data",)).get_group(
    "data")


def step(rows):
    k = rows // world
    for dt, shape in ((torch.float32, (k, 5)), (torch.int32, (k,))):
        full = torch.empty((rows,) + shape[1:], dtype=dt)
        dist.all_gather_into_tensor(full, torch.zeros(shape, dtype=dt),
                                    group=g)


def head(rows, width):
    h = (torch.tensor([rows, width]) if rank == 0
         else torch.empty(2, dtype=torch.int64))
    dist.broadcast(h, src=0, group=g)
    return [int(v) for v in h.tolist()]


def session(n, stop):
    for _ in range(n):
        x = torch.empty(head(64, 16))
        dist.broadcast(x, src=0, group=g)
        step(64)
    if stop:
        head(-1, 0)


for b in (2, 4, 8, 16, 32, 64):
    step(b)
for s in range(4):
    if variant == "nothread":
        session(6, s != 3)
        continue
    t = threading.Thread(target=session, args=(6, s != 3), daemon=True)
    t.start()
    t.join()
if variant == "barrier":
    dist.barrier()
dist.destroy_process_group()
if variant == "osexit":
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
"""


def spawn(script, world, out, extra, tag):
    """One spawn of ``script`` on ``world`` ranks; the rank's exit codes.
    A spawn that fails keeps its directory, with each rank's stderr."""
    tmp = Path(tempfile.mkdtemp(prefix=f"{tag}w{world}_", dir=out))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", REPRO_AUTOTUNE="0")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world),
         str(tmp / "rendezvous"), str(tmp / f"rank{r}.json"), *extra],
        env=dict(env, RANK=str(r)), cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    rcs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            err += "\nTIMEOUT"
        (tmp / f"rank{r}.err").write_text(err)
        rcs.append(p.returncode)
    if all(rc == 0 for rc in rcs):
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()
    return {"world": world, "rcs": rcs, "dir": str(tmp)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", choices=("cont", "gloo"), required=True)
    ap.add_argument("--variant", default="none",
                    choices=("none", "barrier", "osexit", "nothread"))
    ap.add_argument("--no-exit", action="store_true",
                    help="cont: without the EXIT lines")
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "dp_exit_stress")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    if args.target == "cont":
        sys.path.insert(0, str(ROOT / "tests"))
        import test_torch_data_parallel as T
        script = T.CONT
        if args.no_exit:
            assert script.endswith(T.EXIT)
            script = script[:-len(T.EXIT)]
        worlds, extra = (2, 4), []
    else:
        script, worlds, extra = GLOO, (2,), [args.variant]

    def one(i):
        return [spawn(script, w, args.out, extra, f"r{i}") for w in worlds]

    t0, failed = time.time(), 0
    with ThreadPoolExecutor(args.parallel) as ex:
        for i, res in enumerate(ex.map(one, range(args.runs))):
            for r in res:
                if any(rc != 0 for rc in r["rcs"]):
                    failed += 1
                    print(json.dumps({"run": i, **r}), flush=True)
    print(json.dumps({"target": args.target, "variant": args.variant,
                      "no_exit": args.no_exit, "runs": args.runs,
                      "spawns": args.runs * len(worlds),
                      "failed_spawns": failed,
                      "seconds": round(time.time() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
