#!/usr/bin/env python3
"""K1 and K2 at dwn-jsc-lg-2400 (16 features, 200 thresholds, 2400 LUTs of
fan-in 6, 5 classes): a parent tree's ``fused_dwn.cu`` against this
tree's, on one CUDA card, in the same process.

Builds the parent's source (``--parent``: the root of an unpacked
checkout of the parent commit, e.g. from ``git archive``) under the
ignored ``build/k12_ab/`` with this tree's nvcc flags, and loads this
tree's library as the wrappers build it.  At the served buckets 1, 64,
1024 and 4096 it holds both libraries' counts and predictions equal, then
times each launch in CUDA graphs in turns (parent, tree, tree, parent).
The parent's C entries are those before any-depth stacks and the global
scratch (no ``deep_meta`` and no scratch arguments); the script tells
them apart by ``fused_tiles_scratch_blocks``, which only the newer source
exports.  Prints the card's name and power limit, one line a launch, and
one JSON line.

    python3 scripts/k12_ab.py --parent build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.autotune import DEFAULT_CONFIG  # noqa: E402
from repro_torch.kernels.fused import ops as tops  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/fused/csrc/fused_dwn.cu")
BUCKETS = (1, 64, 1024, 4096)
F, T, LUTS, N, C = 16, 200, 2400, 6, 5
P, I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "k12_ab" / "libparent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(parent / SOURCE)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stderr[-3000:])
    return ctypes.CDLL(str(out))


def launcher(lib, variant, ops, x, B):
    """A call of ``lib``'s K2 (``packed``) or K1 entry on the first B rows
    of ``x``; returns (run, counts buffer, predictions)."""
    new = hasattr(lib, "fused_tiles_scratch_blocks")
    buf = torch.zeros(B * C + (B + 31) // 32, dtype=torch.int32,
                      device="cuda")
    idx = torch.empty(B, dtype=torch.int32, device="cuda")
    info = (ctypes.c_int * 8)()
    xb = x[:B]
    tail = [C]
    if variant == "packed":
        thd, layers, masks = ops
        f = lib.fused_dwn_packed_launch
        args = [xb.data_ptr(), thd.data_ptr(), B, F, T,
                layers.meta.ctypes.data]
        if new:
            args.append(layers.meta_dev.data_ptr())
        args += [layers.num_layers, layers.wires.data_ptr(),
                 layers.tab.data_ptr(), masks.data_ptr()]
    else:
        wf, wt, t0, _, masks = ops
        f = lib.fused_dwn_batch_major_launch
        args = [xb.data_ptr(), B, F, wf.data_ptr(), wt.data_ptr(),
                t0.data_ptr(), wf.shape[0], wf.shape[1], t0.shape[1], None]
        if new:
            args.append(None)
        args += [0, None, None, masks.data_ptr()]
    args += tail + [masks.shape[1], buf.data_ptr(), idx.data_ptr(),
                    buf.data_ptr() + 4 * B * C, DEFAULT_CONFIG.block_b]
    if new:
        args += [0, None, 0, 0]
    args.append(info)
    f.restype = I
    f.argtypes = None

    def run():
        err = f(*[P(a) if isinstance(a, int) and a > 2 ** 31 else a
                  for a in args], P(torch.cuda.current_stream().cuda_stream))
        if err:
            raise SystemExit(f"{variant} B={B}: CUDA error {err}")
    return run, buf, idx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the parent commit's unpacked tree")
    args = ap.parse_args()
    libs = {"parent": build_parent(args.parent.resolve()),
            "tree": _build.load("fused_dwn")}
    print(c.nvidia_smi_line(), flush=True)
    rng = np.random.default_rng(0)
    th, maps, tabs = c.make_model(rng, F, T, (LUTS,), N)
    x = torch.from_numpy(rng.uniform(-1, 1, (max(BUCKETS), F)).astype(
        np.float32)).cuda()
    thd = torch.from_numpy(th).cuda()
    ops = {v: tops.prepare_operands(
        thd, [torch.from_numpy(maps[0]).cuda()],
        [torch.from_numpy(tabs[0]).cuda()], C, v)
        for v in ("packed", "batch-major")}
    res = {}
    for variant in ("packed", "batch-major"):
        for B in BUCKETS:
            calls = {n: launcher(lib, variant, ops[variant], x, B)
                     for n, lib in libs.items()}
            for run, _, _ in calls.values():
                run()
            torch.cuda.synchronize()
            (_, b0, i0), (_, b1, i1) = calls.values()
            if not (torch.equal(b0[:B * C], b1[:B * C])
                    and torch.equal(i0, i1)):
                raise SystemExit(f"{variant} B={B}: the trees differ")
            times = {n: [] for n in libs}
            for name in ("parent", "tree", "tree", "parent"):
                times[name].append(c.graph_ms(calls[name][0], iters=100,
                                              replays=5))
            res[f"{variant} {B}"] = times
            print(variant, B, {n: [round(t, 5) for t in v]
                               for n, v in times.items()}, flush=True)
    print(json.dumps({"k12_ab": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
