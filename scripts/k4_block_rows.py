#!/usr/bin/env python3
"""K4's block rows kernel (``lut_eval_packed_block_kernel``) on one CUDA
card: checks and group shapes.

Builds ``kernels/lut_eval/csrc/lut_eval.cu``, prints the block rows
kernels' ptxas lines (registers, spills), then holds the wrapper bit for
bit to ``lut_eval_packed_plain`` at rows of 7265, 8192, 29,057 and 58,112
words (and the kept global kernel at 58,113), fan-in 6, 3 and 16, layers
of 2400 LUTs and of one word, B = 4097, 33 and 1.  Then, at K4_WIDE's
shape (B = 4096 rows of 8192 words, 2400 LUT6), it times in CUDA graphs,
in turns (A B ... B A), the wrapper's plan (two groups of three rows),
each other (rows a group, groups staged) that fits a block through the C
entry, and the kept global kernel, with the bytes bound
(``chip_smoke.model_bytes_and_ops``).  Prints one JSON line (also
written to ``--out``) and the card's name and power limit.

    python3 scripts/k4_block_rows.py [--out F]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: (W_in, fan-in) held to the plain version; the last takes the global
#: kernel
CHECKS = ((7265, 6), (8192, 6), (8192, 3), (8192, 16), (29_057, 6),
          (58_112, 6), (58_113, 6))
#: (rows a group, groups staged) timed at 8192-word rows
SHAPES = ((3, 2), (7, 1), (2, 2), (1, 2), (4, 1), (1, 1))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels._launch import align16, sm_count
    from repro_torch.kernels.fused import ref as R
    from repro_torch.kernels.lut_eval import kernel as KL
    from repro_torch.kernels.lut_eval import ref as RL
    from repro_torch.core.bitpack import from_word_pattern
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_block_rows: no CUDA card", file=sys.stderr)
        return 3
    cs.SM_CLOCK_HZ = cs.max_sm_clock_hz()
    built = _build.build_all(["lut_eval"])["lut_eval"]
    ptxas = {f"cached={c}": cs.ptxas_entry(
        built["ptxas"], f"lut_eval_packed_block_kernelILb{int(c)}E")
        for c in (True, False)}
    rng = np.random.default_rng(0)
    checks = []
    for W_in, n in CHECKS:
        for m in (2400, 32):
            wires = torch.from_numpy(rng.integers(
                0, 32 * W_in, (m, n)).astype(np.int32)).cuda()
            tab = R.pack_table_words(torch.from_numpy(
                rng.integers(0, 2, (m, 2 ** n))).cuda())
            for B in (4097, 33, 1):
                words = torch.from_numpy(rng.integers(
                    -2 ** 31, 2 ** 31, (B, W_in), dtype=np.int64).astype(
                        np.int32)).cuda()
                got = KL.lut_eval_packed(words, wires >> 5, wires & 31, tab)
                torch.cuda.synchronize()
                want = RL.lut_eval_packed_plain(words, wires >> 5,
                                                wires & 31, tab)
                ok = bool(torch.equal(from_word_pattern(got), want))
                checks.append({"W_in": W_in, "n": n, "m": m, "B": B,
                               "equal": ok, **KL.last_launch()})
                if not ok:
                    print(json.dumps({"failed": checks[-1]}), flush=True)
                    return 1
    # timing at K4_WIDE's shape
    B, W_in, m, n = 4096, 8192, 2400, 6
    words = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (B, W_in), dtype=np.int64).astype(
            np.int32)).cuda()
    wires = torch.from_numpy(rng.integers(0, 32 * W_in, (m, n)).astype(
        np.int32)).cuda()
    widx, boff = (wires >> 5).contiguous(), (wires & 31).contiguous()
    tab = R.pack_table_words(torch.from_numpy(
        rng.integers(0, 2, (m, 2 ** n))).cuda())
    want = RL.lut_eval_packed_plain(words, widx, boff, tab)
    out = torch.empty((B, m // 32), dtype=torch.int32, device="cuda")
    ptrs = (words.data_ptr(), B, W_in, widx.data_ptr(), boff.data_ptr(),
            tab.data_ptr(), m, n, tab.shape[1], out.data_ptr())
    calls = {"wrapper": lambda: KL.lut_eval_packed(words, widx, boff, tab),
             "global": cs.rows_kernel(KL.LIBRARY, KL._SIGNATURES,
                                      "lut_eval_packed_rows_launch", *ptrs,
                                      0)}
    info = {}
    for group, bufs in SHAPES:
        smem = bufs * align16(group * W_in * 4)
        if smem > KL.MAX_SMEM_BYTES:
            continue
        info[group, bufs] = (ctypes.c_int * 3)()
        calls[f"{group} rows x {bufs}"] = cs.rows_kernel(
            KL.LIBRARY, KL._SIGNATURES, "lut_eval_packed_block_launch",
            *ptrs, group, bufs, sm_count(torch.device("cuda")), smem,
            info[group, bufs])
    equal = {}
    for name, fn in calls.items():
        out.zero_()
        got = fn()
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(
            from_word_pattern(out if got is None else got), want))
    runs = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            runs[name].append(cs.graph_ms(calls[name], iters=20, replays=3))
    nbytes, ops = cs.model_bytes_and_ops("lut_eval", B, 16, 16384, (m,), n,
                                         5)
    result = {"k4_block_rows_ms": runs, "equal": equal,
              "bound_ms": max(nbytes / cs.PEAK_BYTES_PER_S,
                              cs.ops_seconds(ops)) * 1e3,
              "bytes": nbytes, "launch_info": {
                  f"{g} rows x {b}": list(v) for (g, b), v in info.items()},
              "plan": KL.plan_lut_eval_packed(B, W_in, m, n, 132).__dict__,
              "ptxas": ptxas, "checks": len(checks),
              "check_paths": sorted({(c["W_in"], c["path"],
                                      c.get("staged_rows"), c.get("cached"))
                                     for c in checks}, key=str)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps(result, default=str), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
