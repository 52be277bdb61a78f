#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it: its DWN
serving path, its staged packed and float datapaths, its flash-attention
kernel and qwen3-8b serving at full width.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, the device count, nvidia-smi's name and
   power limit, and its largest SM clock (the operation bounds use it);
2. build   — compiles every CUDA kernel source with nvcc (all at once),
   prints the assembler's register, shared-memory and spill lines and
   the fused kernels' registers and shared memory, and fails if a fused
   kernel spills;
3. kernels — at dwn-jsc-lg width (F=16, T=200, m=2400, n=6, 5 classes,
   operands from a numpy seed) holds K2 (packed) and K1 (batch-major)
   against their plain PyTorch versions on the card, bit for bit, at
   B = 4096, 4097, 1000, 33, 31 and 1 and block_b = the default, 7, 256
   and 4096, for a 2-layer stack (120, 50), a fan-in-8 stack (256, 60) whose
   tables are read word by word, a PEN (1, 8) grid and models larger than
   a block's shared memory (2050 LUTs of fan-in 10 and 70 of fan-in 15,
   whose last layer is split over blocks; 40 of fan-in 16 and a
   (40, 70) fan-in-16 stack, read from global memory), each launch's
   layout held to that; then times both in CUDA graphs at the served
   buckets B = 1, 64, 1024 and 4096 and sweeps block_b at B=4096; last
   the zero kernel of a split launch on its own against ``Tensor.zero_``;
4. staged  — the staged packed datapath at the same width: the three
   stage kernels (packed encode, LUT layer, masked popcount + classify)
   each held against its plain version bit for bit (B = 4096, 1000, 1, the
   (120, 50) stack, PEN, a ragged F*T = 21); then ``encode_packed`` ->
   ``evaluate_packed`` per layer -> ``classify_packed`` at B=4096, equal to
   the fused packed kernel and to the float oracle ``apply_hard``, with
   the launch counters showing one encode, one LUT launch per layer and one
   classify per pass; then each stage kernel, the staged total and the
   fused kernel timed in the same run, in CUDA graphs (the card's time)
   and as a loop of wrapper calls (which includes the host's);
5. float   — the float datapath at the same width: the float encode, the
   float LUT layer (multilinear table evaluation), the group popcount +
   classify and the float fused kernel, each held against its plain
   version (B = 4096, 1000, 1, the (120, 50) stack, PEN, a ragged
   F*T = 21, m = 2402 LUTs of which two count for no class) bit for bit,
   and within a stated tolerance on soft bits and float tables; then
   ``encode`` -> ``evaluate`` per layer -> ``classify`` at B=4096, equal
   to the float fused ``forward``, the staged packed path, the packed
   fused kernel and ``apply_hard``, with the launch counters showing one
   encode, one LUT launch per layer and one classify per pass and one
   fused launch per ``forward``; then each float kernel, the float and
   packed staged totals and the three fused kernels timed in the same
   run, and the float fused kernel's block_b and block_m swept;
6. flash   — the flash-attention kernel against its plain version at the
   qwen3-8b head shape (32 query heads over 8 KV heads, head_dim 128, bf16
   from a numpy seed) for (B, S) in (1, 1), (2, 33), (1, 129), (2, 255),
   (4, 512), (4, 2048), causal and not, for a flat and a peaked softmax,
   within 2e-2 elementwise and within 1e-2 of each query row's largest
   value; then timed at B=4, S=2048 in a CUDA graph beside its plain
   version and one ``scaled_dot_product_attention`` call (a yardstick the
   port never calls), with its TFLOP/s, the bound counted from shapes and
   the share of it reached, and the Hopper kernel's registers, shared
   memory and spills from ptxas (it fails if the kernel spills or ptxas
   serialised its wgmmas);
7. lm      — ``ServingEngine(qwen3-8b with attn_impl="pallas",
   prompt_len=2048, gen=16, device="cuda")`` at full width (36 layers,
   weights from a seed): serves 2 requests of 4 prompts with the launch
   counters showing 36 flash-attention launches per prefill and none in
   decode, then holds the same params with ``attn_impl="masked"`` to the
   kernel's prefill logits and 16 teacher-forced decode steps within
   0.05 of the largest logit; prefill and decode times beside their
   bounds and a profiler split of a prefill and a decode step (it fails
   if the prefill's profile finds no time in K10 while its launches were
   counted);
8. serve   — ``ServingEngine("dwn-jsc-lg", device="cuda")`` at full width,
   whose startup checks every backend against the float oracle; serves 16
   requests of 4096 rows on the packed kernel, the same stream on the
   batch-major kernel and a ragged stream, asserting from the launch
   counters that each kernel carried its pass (and that the zero kernel
   ran before the split launches), and times the host-to-device
   copy, the launch and the device-to-host copy of a step;
9. cli     — ``python -m repro_torch.launch.serve --arch dwn-jsc-lg`` with
   four requests, and ``--arch qwen3-8b --batch 2 --prompt-len 32 --gen 4``.

Then it prints the kernels' summary line, nvidia-smi's line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
so does a machine without a CUDA card, or a directory without the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peak of device memory (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# the DWN kernels' scalar operations, each one instruction, at the CUDA C
# Programming Guide's per-instruction throughputs for compute capability
# 9.0, in lanes per clock per SM: 32-bit integer, logic, shift and compare
# ("int": compares, bit selects, table reads, gathers), float32 add,
# multiply and FMA ("fp32": float sums and lerps), population count
LANES_PER_CLOCK = {"int": 64, "fp32": 128, "popc": 16}
# the classes run on separate pipes at once, but each of an SM's 4
# schedulers dispatches at most one warp instruction a clock: 128 lanes
DISPATCH_LANES_PER_CLOCK = 128
SMS = 132
#: the SM clock the bounds count with: nvidia-smi's clocks.max.sm, read
#: by main() (Hz)
SM_CLOCK_HZ = None
# dense bf16 on the tensor cores (NVIDIA data sheet, H100 SXM)
PEAK_BF16_OPS_PER_S = 989e12

LG = dict(F=16, T=200, m=2400, n=6, C=5)
#: samples per CUDA block (a tile) swept at B=4096 for K1 and K2
BLOCK_B_SWEEP = (32, 64, 128, 256)
#: block_b values K1 and K2 are checked at beside the default: below a
#: warp and not a multiple of 32, eight warps, and more than a block's
#: shared memory holds beside the lg-2400 model (cut to what fits)
BLOCK_B_CHECKED = (7, 256, 4096)
#: the serving engine's batch buckets K1 and K2 are timed at
SERVED_BUCKETS = (1, 64, 1024, 4096)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def max_sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip()) * 1e6


def time_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Mean milliseconds per call on the card with no Python between the
    launches: ``iters`` calls captured in one CUDA graph, replayed
    ``replays`` times between CUDA events.  Where the wrapper's host work
    takes longer than its kernel, :func:`time_ms` measures the host; this
    measures the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def make_model(rng, F, T, counts, n, pen_frac=None):
    """Random thresholds (ascending per feature), wires and {0,1} tables."""
    from repro_torch.core.thermometer import quantize_fixed_point
    th = np.sort(rng.uniform(-1, 1, (F, T)).astype(np.float32), axis=1)
    if pen_frac is not None:
        th = np.asarray(quantize_fixed_point(th, pen_frac), np.float32)
    maps, tabs, cand = [], [], F * T
    for m in counts:
        maps.append(rng.integers(0, cand, (m, n)).astype(np.int32))
        tabs.append(rng.integers(0, 2, (m, 2 ** n)).astype(np.int32))
        cand = m
    return th, maps, tabs


def model_bytes_and_ops(variant, B, F, T, counts, n, C):
    """Bytes the function must move (inputs read once, outputs written
    once) and the scalar operations it does for one launch, by class of
    :data:`LANES_PER_CLOCK`.

    ``variant`` is a fused kernel ("packed", "batch-major") or a stage
    kernel of the staged path: "thermometer" (F*T compares per sample),
    "lut_eval" (the first layer of ``counts``: m*n bit selects and m table
    reads per sample) or "popcount" (the last layer's C*W masked word
    popcounts per sample); or a kernel of the float datapath (float32 bits
    and tables, first layer of ``counts``): "float_thermometer" (F*T
    compares, F*T floats written per sample), "float_lut_eval" (per LUT n
    gathers and the 2^n - 1 lerps of its table, an add and an FMA each),
    "float_popcount" (one float add per LUT output) or "float_fused" (per
    LUT n wired compares, one table read and one float class add).
    """
    words = [(m + 31) // 32 for m in counts]
    w_in = (F * T + 31) // 32
    m0, A = counts[0], 2 ** n
    if variant == "float_thermometer":
        return (B * F * 4 + F * T * 4 + B * F * T * 4,
                {"int": B * F * T})
    if variant == "float_lut_eval":
        nbytes = B * F * T * 4 + m0 * n * 4 + m0 * A * 4 + B * m0 * 4
        return nbytes, {"int": B * m0 * n, "fp32": B * m0 * 2 * (A - 1)}
    if variant == "float_popcount":
        return (B * counts[-1] * 4 + B * C * 4 + B * 4,
                {"fp32": B * counts[-1]})
    if variant == "float_fused":
        nbytes = (B * F * 4 + F * T * 4 + m0 * n * 4 + m0 * A * 4
                  + B * C * 4 + B * 4)
        return nbytes, {"int": B * m0 * (n + 1), "fp32": B * m0}
    if variant == "thermometer":
        return (B * F * 4 + F * T * 4 + B * w_in * 4, {"int": B * F * T})
    if variant == "lut_eval":
        m = counts[0]
        nbytes = (B * w_in * 4 + m * n * 4 * 2 + m * ((2 ** n + 31) // 32)
                  * 4 + B * words[0] * 4)
        return nbytes, {"int": B * m * n + B * m}
    if variant == "popcount":
        return (B * words[-1] * 4 + C * words[-1] * 4 + B * C * 4 + B * 4,
                {"popc": B * C * words[-1]})
    tw = (2 ** n + 31) // 32
    table_bytes = sum(m * tw * 4 for m in counts)
    wire_bytes = sum(m * n * 4 for m in counts)       # one int32 per wire
    io = B * F * 4 + B * C * 4 + B * 4 + C * words[-1] * 4
    reads = B * sum(counts)                           # one table read / LUT
    popc = B * C * words[-1]
    if variant == "packed":
        nbytes = io + F * T * 4 + wire_bytes + table_bytes
        ints = B * F * T + B * sum(m * n for m in counts) + reads
    else:
        # wire_f int16 + wire_th float32 for the first layer
        nbytes = (io + wire_bytes - counts[0] * n * 4 + counts[0] * n * 6
                  + table_bytes)
        ints = (B * counts[0] * n                     # direct-wire compares
                + B * sum(m * n for m in counts[1:]) + reads)
    return nbytes, {"int": ints, "popc": popc}


def ops_seconds(ops: dict) -> float:
    """Least time the card's SMs take for ``ops`` (class -> count): the
    classes' pipes run at once, so the slowest class at its
    per-instruction rate, or all of them at the dispatch rate
    (:data:`DISPATCH_LANES_PER_CLOCK`), whichever is longer."""
    clocks = SMS * SM_CLOCK_HZ
    slowest = max(k / (LANES_PER_CLOCK[c] * clocks) for c, k in ops.items())
    return max(slowest,
               sum(ops.values()) / (DISPATCH_LANES_PER_CLOCK * clocks))


#: the assembler's lines worth printing: resources, spills and the
#: warnings that it serialised wgmma instructions
PTXAS_KEEP = ("registers", "spill", "smem", "Compiling entry",
              "Performance Loss")


#: the fused library's kernels: (symbol in ptxas's entry names, name)
FUSED_SYMBOLS = (
    ("fused_tiles_kernelILb0ELb1E", "fused_dwn_packed"),
    ("fused_tiles_kernelILb0ELb0E", "fused_dwn_packed, model in global"),
    ("fused_tiles_kernelILb1ELb1E", "fused_dwn_batch_major"),
    ("fused_tiles_kernelILb1ELb0E",
     "fused_dwn_batch_major, model in global"),
    ("zero_kernel", "fused_dwn_zero"),
    ("fused_dwn_kernel", "fused_dwn"))


def phase_build():
    """Every kernel library built at once; returns name -> its ptxas
    lines.  The fused kernels' registers, static shared memory and spills
    are printed (the dynamic shared memory of K1 and K2 is in the kernels
    phase, as each launch reports it); a spill fails the run."""
    from repro_torch.kernels import _build
    res = _build.build_all()
    libs = {name: {"seconds": r["seconds"], "cached": r["cached"],
                   "ptxas": [line for line in r["ptxas"]
                             if any(k in line for k in PTXAS_KEEP)]}
            for name, r in res.items()}
    fused = {name: _ptxas_resources(libs["fused_dwn"]["ptxas"], symbol)
             for symbol, name in FUSED_SYMBOLS}
    emit({"phase": "build", "libraries": libs, "fused_kernels": fused})
    return {name: lib["ptxas"] for name, lib in libs.items()}


def phase_kernels(device, batches=(4096, 4097, 1000, 33, 31, 1),
                  time_batch=4096):
    """K2 and K1 equal to their plain versions at every B of ``batches``
    and every block_b of :data:`BLOCK_B_CHECKED`, at lg-2400 width, on a
    2-layer stack, on a fan-in-8 stack (tables past 64 entries, read word
    by word), on a PEN grid and on models larger than a block's shared
    memory (fan-in 10 and 15: the last layer split over blocks; fan-in 16:
    the model read from global memory), each launch's layout held to
    that; then each timed at the served buckets in CUDA graphs, its
    block_b swept at ``time_batch``.  Last the zero kernel of a split
    launch on its own, against ``Tensor.zero_``."""
    import torch
    from repro_torch.kernels.fused import kernel as K
    from repro_torch.kernels.fused import ref as R
    from repro_torch.kernels.fused.ops import prepare_operands
    from repro_torch.core.thermometer import quantize_fixed_point
    from repro_torch.kernels.autotune import DEFAULT_CONFIG

    block_default = DEFAULT_CONFIG.block_b
    rng = np.random.default_rng(0)
    F, T, m, n, C = (LG[k] for k in ("F", "T", "m", "n", "C"))
    x_all = rng.uniform(-1, 1, (max(batches), F)).astype(np.float32)
    # (case, LUTs per layer, fan-in, PEN fraction bits, batches, where
    # the model must be: "split" = staged, the last layer over at least
    # two blocks from B = 4096 on; "global" = read from global memory)
    cases = [("lg-2400", (m,), n, None, batches, None),
             ("stack-120-50", (120, 50), n, None, batches[2:], None),
             ("stack-fan8-256-60", (256, 60), 8, None, batches[1:], None),
             ("lg-2400-pen9", (m,), n, 8, batches[:3], None),
             ("fan10-2050", (2050,), 10, None, batches, "split"),
             ("fan15-70", (70,), 15, None, batches[2:], "split"),
             ("fan16-40", (40,), 16, None, batches[1:], "global"),
             ("stack-fan16-40-70", (40, 70), 16, None, batches[2:],
              "global")]
    kernels = {"packed": (K.fused_dwn_packed, R.fused_dwn_packed_plain),
               "batch-major": (K.fused_dwn_batch_major,
                               R.fused_dwn_batch_major_plain)}
    checks, max_err, timing = [], {v: 0.0 for v in kernels}, {}
    for case, counts, fan_in, frac, bs, where in cases:
        th, maps, tabs = make_model(rng, F, T, counts, fan_in, frac)
        th_d = torch.from_numpy(th).to(device)
        maps_d = [torch.from_numpy(a).to(device) for a in maps]
        tabs_d = [torch.from_numpy(a).to(device) for a in tabs]
        for variant, (kern, plain) in kernels.items():
            ops = prepare_operands(th_d, maps_d, tabs_d, C, variant)
            for B in bs:
                xb = x_all[:B]
                if frac is not None:
                    xb = quantize_fixed_point(xb, frac).astype(np.float32)
                x = torch.from_numpy(np.ascontiguousarray(xb)).to(device)
                ref_c, ref_i = plain(x, *ops)
                for block_b in (block_default, *BLOCK_B_CHECKED):
                    got_c, got_i = kern(x, *ops, block_b=block_b)
                    torch.cuda.synchronize()
                    err = float((got_c - ref_c).abs().max()) if B else 0.0
                    equal = bool(torch.equal(got_c, ref_c)
                                 and torch.equal(got_i, ref_i))
                    lay = K.last_launch()
                    placed = (where is None or not B
                              or (where == "global") == (not lay["staged"])
                              and (where != "split" or B < 4096
                                   or lay["slices"] > 1))
                    checks.append({"case": case, "variant": variant,
                                   "B": B, "block_b": block_b,
                                   "equal": equal, "layout": lay})
                    max_err[variant] = max(max_err[variant], err)
                    if not (equal and placed):
                        emit({"phase": "kernels", "checks": checks})
                        raise SystemExit(
                            f"{variant} kernel differs from its plain "
                            f"version or is not {where}: {case}, B={B}, "
                            f"block_b={block_b}, max |diff| {err}, {lay}")
            if case == "lg-2400":
                x = torch.from_numpy(x_all[:time_batch]).to(device)
                timing[variant] = {
                    "ms": graph_ms(lambda: kern(x, *ops,
                                                block_b=block_default)),
                    "eager_ms": time_ms(lambda: kern(
                        x, *ops, block_b=block_default), iters=200,
                        warmup=10),
                    "plain_ms": time_ms(lambda: plain(x, *ops), iters=5,
                                        warmup=1),
                    **_bound(variant, time_batch, F, T, counts, n, C),
                    "bucket_ms": {
                        B: graph_ms(lambda B=B: kern(
                            x[:B], *ops, block_b=block_default))
                        for B in SERVED_BUCKETS},
                    "bucket_layout": {
                        B: (kern(x[:B], *ops, block_b=block_default),
                            K.last_launch())[1]
                        for B in SERVED_BUCKETS},
                    "bucket_bound_ms": {
                        B: _bound(variant, B, F, T, counts, n, C)[
                            "bound_ms"] for B in SERVED_BUCKETS},
                    "block_b_ms": {
                        bb: graph_ms(lambda bb=bb: kern(x, *ops,
                                                        block_b=bb))
                        for bb in BLOCK_B_SWEEP}}
    timing["zero"] = _zero_kernel(device, F=F, C=C)
    emit({"phase": "kernels", "checks": len(checks),
          "all_equal": all(c["equal"] for c in checks),
          "max_abs_err": max_err, "timing_batch": time_batch,
          "block_b": block_default,
          "layouts": sorted({(c["case"], c["layout"]["staged"],
                              c["layout"]["slices"]) for c in checks
                             if c["B"]}),
          "timing": timing})
    return max_err, timing


def _zero_kernel(device, F, C, B=1024):
    """The zero kernel on its own at the size a split launch of B rows
    gives it (B*C counts and a counter per tile of 32), on a buffer of
    garbage: equal to ``Tensor.zero_``, then timed beside it in CUDA
    graphs."""
    import torch
    from repro_torch.kernels.fused import kernel as K
    n = B * C + (B + 31) // 32
    buf = torch.randint(1, 2 ** 30, (n,), dtype=torch.int32, device=device)
    K.fused_dwn_zero(buf)
    torch.cuda.synchronize()
    err = float(buf.abs().max())
    if err:
        raise SystemExit(f"fused_dwn_zero left {err} in its buffer")
    nbytes = 4 * n
    zero_ms = graph_ms(lambda: buf.zero_())
    return {"ms": graph_ms(lambda: K.fused_dwn_zero(buf)),
            "plain_ms": zero_ms, "library_ms": zero_ms, "max_abs_err": err,
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "B": B}


STAGES = {
    # kernel: (source, the TPU kernel it replaces, bytes/ops variant)
    "thermometer_encode_packed": (
        "src/repro_torch/kernels/thermometer/csrc/thermometer.cu",
        "src/repro/kernels/thermometer/kernel.py:78", "thermometer"),
    "lut_eval_packed": (
        "src/repro_torch/kernels/lut_eval/csrc/lut_eval.cu",
        "src/repro/kernels/lut_eval/kernel.py:99", "lut_eval"),
    "popcount_classify_packed": (
        "src/repro_torch/kernels/popcount/csrc/popcount.cu",
        "src/repro/kernels/popcount/kernel.py:79", "popcount"),
}


def _bound(variant, B, F, T, counts, n, C):
    nbytes, ops = model_bytes_and_ops(variant, B, F, T, counts, n, C)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, ops_seconds(ops)
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": sum(ops.values()),
            "operations_by_class": ops}


def _stage_kernels():
    """The wrapper modules of the stage kernels (thermometer, LUT layer,
    popcount; each holds a float and a packed kernel)."""
    from repro_torch.kernels.lut_eval import kernel as KL
    from repro_torch.kernels.popcount import kernel as KP
    from repro_torch.kernels.thermometer import kernel as KT
    return KT, KL, KP


def _kernel_modules():
    """Every kernel wrapper module: the fused kernels', the stages' and
    flash attention's."""
    from repro_torch.kernels.flash_attn import kernel as KA
    from repro_torch.kernels.fused import kernel as KF
    return (KF, *_stage_kernels(), KA)


def _reset_counts():
    for K in _kernel_modules():
        K.reset_launch_counts()


def _expect_launches(what, want):
    """Every kernel's launches since :func:`_reset_counts`; raise unless
    they are ``want`` (kernels it does not name: 0)."""
    got = {name: n for K in _kernel_modules()
           for name, n in K.launch_counts().items()}
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise SystemExit(f"{what} launched {got}, not {want}")
    return {name: n for name, n in got.items() if n}


def _staged_pass(x, th, maps, tabs, C):
    """One pass of the staged path through the public ops, counts set to
    0 just before and read just after; returns (counts, idx, launches)."""
    import torch
    from repro_torch.kernels.lut_eval.ops import evaluate_packed
    from repro_torch.kernels.popcount.ops import classify_packed
    from repro_torch.kernels.thermometer.ops import encode_packed
    _reset_counts()
    packed = encode_packed(x, th)
    for mp, tb in zip(maps, tabs):
        packed = evaluate_packed(packed, mp, tb)
    counts, idx = classify_packed(packed, C)
    torch.cuda.synchronize()
    launches = _expect_launches("staged pass", {
        "thermometer_encode_packed": 1, "lut_eval_packed": len(maps),
        "popcount_classify_packed": 1})
    return counts, idx, launches


def phase_staged(device, batches=(4096, 1000, 1), time_batch=4096):
    """The three stage kernels equal to their plain versions; the staged
    path equal to the fused kernel and the float oracle; timings."""
    import torch
    from repro_torch.core import bitpack as bp
    from repro_torch.core.classifier import predict
    from repro_torch.core.model import JSC_PRESETS, FrozenDWN, apply_hard
    from repro_torch.core.thermometer import quantize_fixed_point
    from repro_torch.kernels.fused import ref as FR
    from repro_torch.kernels.fused.ops import make_forward_packed
    from repro_torch.kernels.lut_eval import kernel as KL
    from repro_torch.kernels.lut_eval import ref as RL
    from repro_torch.kernels.popcount import kernel as KP
    from repro_torch.kernels.popcount import ref as RP
    from repro_torch.kernels.thermometer import kernel as KT
    from repro_torch.kernels.thermometer import ref as RT

    rng = np.random.default_rng(1)
    F, T, m, n, C = (LG[k] for k in ("F", "T", "m", "n", "C"))
    x_all = rng.uniform(-1, 1, (max(batches), F)).astype(np.float32)
    cases = [("lg-2400", F, T, (m,), None, batches),
             ("stack-120-50", F, T, (120, 50), None, batches[1:]),
             ("lg-2400-pen9", F, T, (m,), 8, batches[:2]),
             ("ragged-3x7", 3, 7, (40,), None, batches)]
    checks, max_err, models = [], dict.fromkeys(STAGES, 0.0), {}

    def held(name, case, B, got, ref):
        err = float((got.double() - ref.double()).abs().max()) if B else 0.0
        equal = bool(torch.equal(got, ref))
        checks.append({"kernel": name, "case": case, "B": B,
                       "equal": equal})
        max_err[name] = max(max_err[name], err)
        if not equal:
            emit({"phase": "staged", "checks": checks})
            raise SystemExit(f"{name} differs from its plain version: "
                             f"{case}, B={B}, max |diff| {err}")

    for case, Fc, Tc, counts, frac, bs in cases:
        th, maps, tabs = make_model(rng, Fc, Tc, counts, n, frac)
        th_d = torch.from_numpy(th).to(device)
        maps_d = [torch.from_numpy(a).to(device) for a in maps]
        tabs_d = [torch.from_numpy(a).to(device) for a in tabs]
        layers, cand = [], Fc * Tc
        for mp, tb in zip(maps_d, tabs_d):
            stack = FR.LayerStack.build([mp], [tb], cand, device)
            layers.append(next(stack.layers()))
            cand = mp.shape[0]
        masks = bp.to_word_pattern(bp.group_masks(cand, C, device))
        models[case] = (th, maps, tabs, th_d, maps_d, tabs_d, layers, masks)
        for B in bs:
            xb = np.ascontiguousarray(x_all[:B, :Fc])
            if frac is not None:
                xb = quantize_fixed_point(xb, frac).astype(np.float32)
            x = torch.from_numpy(xb).to(device)
            words = KT.thermometer_encode_packed(x, th_d)
            torch.cuda.synchronize()
            held("thermometer_encode_packed", case, B,
                 bp.from_word_pattern(words),
                 RT.thermometer_packed_plain(x, th_d))
            for (widx, boff, tab), m_l in zip(layers, counts):
                out = KL.lut_eval_packed(words, widx, boff, tab)
                torch.cuda.synchronize()
                held("lut_eval_packed", case, B, bp.from_word_pattern(out),
                     RL.lut_eval_packed_plain(words, widx, boff, tab))
                if bp.unpack_bits(out, out.shape[1] * 32)[:, m_l:].any():
                    raise SystemExit(f"lut_eval_packed set a pad bit past "
                                     f"LUT {m_l}: {case}, B={B}")
                words = out
            got_c, got_i = KP.popcount_classify_packed(words, masks)
            torch.cuda.synchronize()
            ref_c, ref_i = RP.popcount_classify_packed_plain(words, masks)
            held("popcount_classify_packed", case, B, got_c, ref_c)
            held("popcount_classify_packed", case, B, got_i, ref_i)

    # the staged path end to end at dwn-jsc-lg width, then on the stack
    x = torch.from_numpy(x_all[:time_batch]).to(device)
    launches = dict.fromkeys(STAGES, 0)
    passes = {}
    for case in ("lg-2400", "stack-120-50"):
        th, maps, tabs, th_d, maps_d, tabs_d, _, _ = models[case]
        counts, idx, got = _staged_pass(x, th_d, maps_d, tabs_d, C)
        for name in launches:
            launches[name] += got[name]
        k2_c, k2_i = make_forward_packed(th_d, maps_d, tabs_d, C)(x)
        cfg = (JSC_PRESETS["lg-2400"] if case == "lg-2400" else
               dataclasses.replace(JSC_PRESETS["lg-2400"],
                                   lut_counts=(120, 50)))
        oracle = apply_hard(FrozenDWN(cfg, th, maps, tabs), x)
        passes[case] = {
            "launches": got,
            "equal_fused_packed": bool(torch.equal(counts, k2_c)
                                       and torch.equal(idx, k2_i)),
            "equal_apply_hard": bool(torch.equal(counts, oracle) and
                                     torch.equal(idx, predict(oracle)))}
        if not all(v for k, v in passes[case].items() if k != "launches"):
            emit({"phase": "staged", "passes": passes})
            raise SystemExit(f"staged path differs on {case}: "
                             f"{passes[case]}")

    # times at time_batch, lg-2400, prepared operands
    th, maps, tabs, th_d, maps_d, tabs_d, layers, masks = models["lg-2400"]
    [(widx, boff, tab)] = layers
    w0 = KT.thermometer_encode_packed(x, th_d)
    w1 = KL.lut_eval_packed(w0, widx, boff, tab)
    shape = (time_batch, F, T, (m,), n, C)
    kern = {"thermometer_encode_packed": (
                lambda: KT.thermometer_encode_packed(x, th_d),
                lambda: RT.thermometer_packed_plain(x, th_d)),
            "lut_eval_packed": (
                lambda: KL.lut_eval_packed(w0, widx, boff, tab),
                lambda: RL.lut_eval_packed_plain(w0, widx, boff, tab)),
            "popcount_classify_packed": (
                lambda: KP.popcount_classify_packed(w1, masks),
                lambda: RP.popcount_classify_packed_plain(w1, masks))}
    # "ms": the card's time per launch (CUDA graph); "eager_ms": a loop of
    # wrapper calls, which measures the host where it is the slower
    timing = {}
    for name, (fn, plain) in kern.items():
        timing[name] = {"ms": graph_ms(fn),
                        "eager_ms": time_ms(fn, iters=200, warmup=10),
                        "plain_ms": time_ms(plain, iters=5, warmup=1),
                        **_bound(STAGES[name][2], *shape)}
    fused = make_forward_packed(th_d, maps_d, tabs_d, C)

    def three():
        return KP.popcount_classify_packed(KL.lut_eval_packed(
            KT.thermometer_encode_packed(x, th_d), widx, boff, tab), masks)
    staged = {
        "kernels_ms": graph_ms(three),
        "kernels_eager_ms": time_ms(three, iters=200, warmup=10),
        "ops_ms": time_ms(lambda: _staged_pass(x, th_d, maps_d, tabs_d, C),
                          iters=20, warmup=2),
        "bound_ms": sum(t["bound_ms"] for t in timing.values()),
        "fused_packed_ms": graph_ms(lambda: fused(x)),
        "fused_packed_eager_ms": time_ms(lambda: fused(x), iters=200,
                                         warmup=10),
        "fused_packed_bound_ms": _bound("packed", *shape)["bound_ms"]}
    emit({"phase": "staged", "checks": len(checks),
          "all_equal": all(c["equal"] for c in checks),
          "max_abs_err": max_err, "passes": passes,
          "timing_batch": time_batch, "timing": timing, "staged": staged})
    return max_err, timing, launches


FLOAT = {
    # kernel: (source, the TPU kernel it replaces, bytes/ops variant)
    "thermometer_encode": (
        "src/repro_torch/kernels/thermometer/csrc/thermometer.cu",
        "src/repro/kernels/thermometer/kernel.py:44", "float_thermometer"),
    "lut_eval": (
        "src/repro_torch/kernels/lut_eval/csrc/lut_eval.cu",
        "src/repro/kernels/lut_eval/kernel.py:54", "float_lut_eval"),
    "popcount_classify": (
        "src/repro_torch/kernels/popcount/csrc/popcount.cu",
        "src/repro/kernels/popcount/kernel.py:41", "float_popcount"),
    "fused_dwn": (
        "src/repro_torch/kernels/fused/csrc/fused_dwn.cu",
        "src/repro/kernels/fused/kernel.py:107", "float_fused"),
}
#: where an operand is not {0,1} the float kernels are held to their plain
#: versions within a tolerance (nvcc contracts a*b+c into FMA, eager
#: PyTorch rounds twice): the reference's own for soft bits in the LUT
#: layer (tests/test_kernels.py:54) and for float tables in the fused
#: kernel (tests/test_kernels.py:85).  Every other check is exact.
SOFT_BITS_ATOL = 1e-5
FLOAT_TABLES_ATOL = 1e-4
#: fused_dwn's samples per block and LUTs per tile swept at B=4096
FUSED_DWN_BLOCK_B_SWEEP = (8, 16, 32, 64, 128)
FUSED_DWN_BLOCK_M_SWEEP = (32, 64, 128, 256)


def _float_pass(x, th, maps, tabs, C):
    """One pass of the float staged path through the public ops, counts
    set to 0 just before and read just after; returns (counts, idx,
    launches)."""
    import torch
    from repro_torch.kernels.lut_eval.ops import evaluate
    from repro_torch.kernels.popcount.ops import classify
    from repro_torch.kernels.thermometer.ops import encode
    _reset_counts()
    bits = encode(x, th)
    for mp, tb in zip(maps, tabs):
        bits = evaluate(bits, mp, tb)
    counts, idx = classify(bits, C)
    torch.cuda.synchronize()
    launches = _expect_launches("float pass", {
        "thermometer_encode": 1, "lut_eval": len(maps),
        "popcount_classify": 1})
    return counts, idx, launches


def _forward_pass(x, th, mapping, tables, C):
    """One call of the float fused op, counts set to 0 just before and
    read just after; returns (counts, idx, launches)."""
    import torch
    from repro_torch.kernels.fused.ops import forward
    _reset_counts()
    counts, idx = forward(x, th, mapping, tables, C)
    torch.cuda.synchronize()
    return (counts, idx,
            _expect_launches("forward", {"fused_dwn": 1}))


def phase_float(device, batches=(4096, 1000, 1), time_batch=4096):
    """The four float kernels equal to their plain versions; the float
    staged path equal to the float fused kernel, the packed staged path,
    the packed fused kernel and the float oracle; timings."""
    import torch
    from repro_torch.core.classifier import predict
    from repro_torch.core.model import JSC_PRESETS, FrozenDWN, apply_hard
    from repro_torch.core.thermometer import quantize_fixed_point
    from repro_torch.kernels.autotune import FusedConfig
    from repro_torch.kernels.fused import kernel as KF
    from repro_torch.kernels.fused import ref as RF
    from repro_torch.kernels.fused.ops import make_forward_packed
    from repro_torch.kernels.lut_eval import ref as RL
    from repro_torch.kernels.popcount import ref as RP
    from repro_torch.kernels.thermometer import ref as RT
    KT, KL, KP = _stage_kernels()

    rng = np.random.default_rng(2)
    F, T, m, n, C = (LG[k] for k in ("F", "T", "m", "n", "C"))
    x_all = rng.uniform(-1, 1, (max(batches), F)).astype(np.float32)
    # (case, F, T, LUTs per layer, PEN fraction bits, batches)
    cases = [("lg-2400", F, T, (m,), None, batches),
             ("stack-120-50", F, T, (120, 50), None, batches[1:]),
             ("lg-2400-pen9", F, T, (m,), 8, batches[:2]),
             ("ragged-3x7", 3, 7, (40,), None, batches),
             ("lg-2402", F, T, (m + 2,), None, batches[:2])]
    checks, max_err, models = [], dict.fromkeys(FLOAT, 0.0), {}

    def held(name, case, got, ref, atol=0.0, **extra):
        B = got.shape[0]
        err = float((got.double() - ref.double()).abs().max()) if B else 0.0
        ok = bool(torch.equal(got, ref)) if atol == 0.0 else err <= atol
        checks.append({"kernel": name, "case": case, "B": B,
                       "atol": atol, "ok": ok, **extra})
        max_err[name] = max(max_err[name], err)
        if not ok:
            emit({"phase": "float", "checks": checks})
            raise SystemExit(f"{name} differs from its plain version: "
                             f"{case}, B={B}, max |diff| {err} > {atol}")

    def corner_major(tab):
        return tab.to(torch.float32).T.contiguous()

    for case, Fc, Tc, counts, frac, bs in cases:
        th, maps, tabs = make_model(rng, Fc, Tc, counts, n, frac)
        th_d = torch.from_numpy(th).to(device)
        maps_d = [torch.from_numpy(a).to(device) for a in maps]
        tabs_d = [torch.from_numpy(a).to(device) for a in tabs]
        models[case] = (th, maps, tabs, th_d, maps_d, tabs_d)
        for B in bs:
            xb = np.ascontiguousarray(x_all[:B, :Fc])
            if frac is not None:
                xb = quantize_fixed_point(xb, frac).astype(np.float32)
            x = torch.from_numpy(xb).to(device)
            bits = KT.thermometer_encode(x, th_d)
            torch.cuda.synchronize()
            held("thermometer_encode", case, bits,
                 RT.thermometer_plain(x, th_d))
            bits = bits.reshape(B, Fc * Tc)
            for mp, tb in zip(maps_d, tabs_d):
                out = KL.lut_eval(bits, mp, corner_major(tb))
                torch.cuda.synchronize()
                held("lut_eval", case, out, RL.lut_eval_plain(bits, mp, tb))
                bits = out
            if bits.shape[1] % C == 0:
                got_c, got_i = KP.popcount_classify(bits, C)
                torch.cuda.synchronize()
                ref_c, ref_i = RP.popcount_classify_plain(bits, C)
                held("popcount_classify", case, got_c, ref_c)
                held("popcount_classify", case, got_i, ref_i)
            if len(counts) == 1:
                tab_f = tabs_d[0].to(torch.float32)
                ref_c, ref_i = RF.fused_dwn_plain(x, th_d, maps_d[0], tab_f,
                                                  C)
                blocks = ([(KF.FUSED_DWN_BLOCK_B, KF.FUSED_DWN_BLOCK_M),
                           (7, 7), (1, 256), (64, 100)] if B == 1000
                          else [(KF.FUSED_DWN_BLOCK_B, KF.FUSED_DWN_BLOCK_M)])
                for bb, bm in blocks:
                    got_c, got_i = KF.fused_dwn(x, th_d, maps_d[0], tab_f, C,
                                                block_b=bb, block_m=bm)
                    torch.cuda.synchronize()
                    held("fused_dwn", case, got_c, ref_c, block_b=bb,
                         block_m=bm)
                    held("fused_dwn", case, got_i, ref_i, block_b=bb,
                         block_m=bm)

    # denormal features against 0.0 thresholds: IEEE compares (no
    # flush-to-zero), so 1e-40 is above 0.0 and -1e-40 is not
    dn = torch.tensor([[1e-40, -1e-40, 0.0]], device=device)
    dn_bits = KT.thermometer_encode(dn, torch.zeros((3, 2), device=device))
    torch.cuda.synchronize()
    held("thermometer_encode", "denormals", dn_bits.reshape(1, 6),
         torch.tensor([[1.0, 1.0, 0.0, 0.0, 0.0, 0.0]], device=device))

    # operands off {0,1}: soft bits into the LUT layer, float tables in
    # both; held within the stated tolerances
    th, maps, tabs, th_d, maps_d, tabs_d = models["lg-2400"]
    mp = maps_d[0]
    soft = torch.from_numpy(rng.uniform(0, 1, (1000, F * T)).astype(
        np.float32)).to(device)
    ftab = torch.from_numpy(rng.uniform(-1, 1, (m, 2 ** n)).astype(
        np.float32)).to(device)
    for label, tb in (("binary-tables", tabs_d[0].to(torch.float32)),
                      ("float-tables", ftab)):
        out = KL.lut_eval(soft, mp, corner_major(tb))
        torch.cuda.synchronize()
        held("lut_eval", f"soft-bits-{label}", out,
             RL.lut_eval_plain(soft, mp, tb), atol=SOFT_BITS_ATOL)
    x = torch.from_numpy(x_all[:time_batch]).to(device)
    got_c, got_i = KF.fused_dwn(x, th_d, mp, ftab, C)
    torch.cuda.synchronize()
    ref_c, ref_i = RF.fused_dwn_plain(x, th_d, mp, ftab, C)
    held("fused_dwn", "float-tables", got_c, ref_c, atol=FLOAT_TABLES_ATOL)
    top2 = ref_c.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > FLOAT_TABLES_ATOL
    held("fused_dwn", "float-tables-idx", got_i[clear], ref_i[clear],
         rows_compared=int(clear.sum()))

    # the float path end to end at dwn-jsc-lg width, then on the stack
    launches = dict.fromkeys(FLOAT, 0)
    passes = {}
    for case in ("lg-2400", "stack-120-50"):
        th, maps, tabs, th_d, maps_d, tabs_d = models[case]
        counts, idx, got = _float_pass(x, th_d, maps_d, tabs_d, C)
        for name, k in got.items():
            launches[name] += k
        passes[case] = {"float_pass_launches": got}
        sc, si, _ = _staged_pass(x, th_d, maps_d, tabs_d, C)
        k2_c, k2_i = make_forward_packed(th_d, maps_d, tabs_d, C)(x)
        cfg = (JSC_PRESETS["lg-2400"] if case == "lg-2400" else
               dataclasses.replace(JSC_PRESETS["lg-2400"],
                                   lut_counts=(120, 50)))
        oracle = apply_hard(FrozenDWN(cfg, th, maps, tabs), x)
        same = {"equal_staged_packed": (sc, si),
                "equal_fused_packed": (k2_c, k2_i),
                "equal_apply_hard": (oracle, predict(oracle))}
        if case == "lg-2400":
            fc, fi, fgot = _forward_pass(x, th_d, maps_d[0], tabs_d[0], C)
            launches["fused_dwn"] += fgot["fused_dwn"]
            passes[case]["forward_launches"] = fgot
            same["equal_fused_dwn"] = (fc, fi)
        for key, (c, i) in same.items():
            passes[case][key] = bool(torch.equal(counts, c)
                                     and torch.equal(idx, i))
        if not all(v for k, v in passes[case].items() if k.startswith("eq")):
            emit({"phase": "float", "passes": passes})
            raise SystemExit(f"float path differs on {case}: "
                             f"{passes[case]}")

    # times at time_batch, lg-2400, prepared operands
    th, maps, tabs, th_d, maps_d, tabs_d = models["lg-2400"]
    B, g = time_batch, m // C
    mp, tab_f = maps_d[0], tabs_d[0].to(torch.float32)
    tab_t = corner_major(tab_f)
    bits = KT.thermometer_encode(x, th_d).reshape(B, -1)
    out = KL.lut_eval(bits, mp, tab_t)
    shape = (B, F, T, (m,), n, C)
    # name: (kernel, plain version, eager yardstick of two PyTorch calls
    # or None where no PyTorch call computes the function)
    kern = {
        "thermometer_encode": (
            lambda: KT.thermometer_encode(x, th_d),
            lambda: RT.thermometer_plain(x, th_d),
            lambda: (x[:, :, None] > th_d).float()),
        "lut_eval": (
            lambda: KL.lut_eval(bits, mp, tab_t),
            lambda: RL.lut_eval_plain(bits, mp, tab_f), None),
        "popcount_classify": (
            lambda: KP.popcount_classify(out, C),
            lambda: RP.popcount_classify_plain(out, C),
            lambda: out.view(B, C, g).sum(-1).argmax(-1)),
        "fused_dwn": (
            lambda: KF.fused_dwn(x, th_d, mp, tab_f, C),
            lambda: RF.fused_dwn_plain(x, th_d, mp, tab_f, C), None)}
    # "ms": the card's time per launch (CUDA graph); "eager_ms": a loop of
    # wrapper calls, which measures the host where it is the slower
    timing = {}
    for name, (fn, plain, yardstick) in kern.items():
        timing[name] = {
            "ms": graph_ms(fn),
            "eager_ms": time_ms(fn, iters=200, warmup=10),
            "plain_ms": time_ms(plain, iters=5, warmup=1),
            "library_ms": graph_ms(yardstick) if yardstick else None,
            **_bound(FLOAT[name][2], *shape)}
    timing["fused_dwn"]["block_b_ms"] = {
        bb: graph_ms(lambda: KF.fused_dwn(x, th_d, mp, tab_f, C, block_b=bb),
                     iters=50)
        for bb in FUSED_DWN_BLOCK_B_SWEEP}
    timing["fused_dwn"]["block_m_ms"] = {
        bm: graph_ms(lambda: KF.fused_dwn(x, th_d, mp, tab_f, C, block_m=bm),
                     iters=50)
        for bm in FUSED_DWN_BLOCK_M_SWEEP}

    # the float staged path beside the packed one and the fused kernels
    from repro_torch.core import bitpack as bp
    stack = RF.LayerStack.build([mp], [tabs_d[0]], F * T, device)
    [(widx, boff, tab_w)] = list(stack.layers())
    masks = bp.to_word_pattern(bp.group_masks(m, C, device))
    k2 = make_forward_packed(th_d, maps_d, tabs_d, C)
    k1 = make_forward_packed(th_d, maps_d, tabs_d, C,
                             config=FusedConfig("batch-major"))

    def float_three():
        b = KT.thermometer_encode(x, th_d).reshape(B, -1)
        return KP.popcount_classify(KL.lut_eval(b, mp, tab_t), C)

    def packed_three():
        return KP.popcount_classify_packed(KL.lut_eval_packed(
            KT.thermometer_encode_packed(x, th_d), widx, boff, tab_w), masks)
    float_bound = sum(timing[k]["bound_ms"] for k in
                      ("thermometer_encode", "lut_eval",
                       "popcount_classify"))
    packed_bound = sum(_bound(STAGES[k][2], *shape)["bound_ms"]
                       for k in STAGES)
    staged = {
        "float_kernels_ms": graph_ms(float_three),
        "float_kernels_eager_ms": time_ms(float_three, iters=50, warmup=5),
        "float_ops_ms": time_ms(
            lambda: _float_pass(x, th_d, maps_d, tabs_d, C), iters=20,
            warmup=2),
        "float_bound_ms": float_bound,
        "packed_kernels_ms": graph_ms(packed_three),
        "packed_bound_ms": packed_bound,
        "fused_dwn_ms": graph_ms(kern["fused_dwn"][0]),
        "fused_packed_ms": graph_ms(lambda: k2(x)),
        "fused_packed_bound_ms": _bound("packed", *shape)["bound_ms"],
        "batch_major_ms": graph_ms(lambda: k1(x)),
        "batch_major_bound_ms": _bound("batch-major", *shape)["bound_ms"]}
    staged["float_over_packed"] = (staged["float_kernels_ms"]
                                   / staged["packed_kernels_ms"])
    staged["float_bound_over_packed_bound"] = float_bound / packed_bound
    staged["fused_dwn_over_fused_packed"] = (staged["fused_dwn_ms"]
                                             / staged["fused_packed_ms"])
    emit({"phase": "float", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks),
          "max_abs_err": max_err, "passes": passes,
          "timing_batch": time_batch, "timing": timing, "staged": staged})
    return max_err, timing, launches


FLASH = ("src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
         "src/repro/kernels/flash_attn/kernel.py:74")
#: what every flash-attention kernel's symbol holds; the profile split
#: finds K10 by it
FLASH_SYMBOL = "flash_attn_kernel"
#: the qwen3-8b attention head shape: query heads, KV heads, head_dim
QWEN_HEADS = (32, 8, 128)
#: the symbol of the Hopper design (hd 128), whose ptxas lines are held to
#: no spills and no wgmma serialisation
FLASH_WS_SYMBOL = FLASH_SYMBOL + "_ws"
#: flash attention (bf16 out, P rounded to bf16) against its float32
#: plain version: the reference's bf16 bar (tests/test_flash_kernel.py:41),
#: absolute and relative, as torch.testing.assert_close applies them
FLASH_TOL = 2e-2
#: and per query row: max |diff| over the row's head dims over max |want|
#: there.  Deep in a flat softmax |o| is about 1 / sqrt(0.78 * row), far
#: below FLASH_TOL, so the elementwise bar alone passes a kernel that
#: drops a key tile or skips the rescale of O; bf16 rounding of P and of
#: the output stays within a few 1e-3 of each row's largest value
FLASH_ROW_REL = 1e-2
#: scales of q (k and v are N(0, 1)): a flat softmax (scores with a
#: standard deviation of 0.5) and a peaked one (4), where |o| is O(1)
FLASH_Q_SCALES = (0.5, 4.0)
#: K10 prefill logits and teacher-forced decode logits against the masked
#: path on the same params: max |diff| over max |logit|, the reference's
#: prefill/decode consistency bar (tests/test_decode_consistency.py:44)
LOGITS_REL = 0.05


def flash_bytes_and_ops(B, S, H, KH, hd, causal=True):
    """Bytes of q, k, v and o (bf16, each once) and the tensor-core
    operations of the two products over the keys each query sees."""
    nbytes = 2 * B * S * hd * (2 * H + 2 * KH)
    pairs = S * (S + 1) // 2 if causal else S * S
    return nbytes, 4 * B * H * hd * pairs


def _bf16_bound(nbytes, nops):
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": nops}


def _ptxas_resources(lines, symbol):
    """Registers, shared memory and spill bytes of the kernel whose mangled
    name holds ``symbol``, from ptxas's -v lines (an entry's lines follow
    its "Compiling entry" line), and any wgmma serialisation warning.
    Raises if the kernel's lines are missing, if it spills or if ptxas
    serialised its wgmmas."""
    out = {"warnings": [line for line in lines
                        if "Performance Loss" in line and symbol in line]}
    inside = False
    for line in lines:
        if "Compiling entry" in line:
            inside = symbol in line
        elif inside and "spill" in line:
            out["spill_bytes"] = [int(n) for n in re.findall(
                r"(\d+) bytes spill", line)]
        elif inside and "Used" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    if "registers" not in out or "spill_bytes" not in out:
        raise SystemExit(f"ptxas reported no registers or spills for "
                         f"{symbol!r}: {out}")
    if any(out["spill_bytes"]) or out["warnings"]:
        raise SystemExit(f"ptxas spilled or serialised the wgmmas of "
                         f"{symbol!r}: {out}")
    return out


def flash_errors(got, want):
    """``got`` (the kernel's bf16) against ``want`` (float32): the largest
    |diff|, the largest per-row relative error (see FLASH_ROW_REL) and
    whether both bars and finiteness hold."""
    import torch
    diff = (got.float() - want).abs()
    row_rel = float((diff.amax(-1) / want.abs().amax(-1).clamp_min(1e-30))
                    .max())
    ok = bool((diff <= FLASH_TOL + FLASH_TOL * want.abs()).all()
              and torch.isfinite(got).all() and row_rel <= FLASH_ROW_REL)
    return {"max_abs_err": float(diff.max()), "row_rel_err": row_rel,
            "ok": ok}


def phase_flash(device, ptxas=(), sizes=((1, 1), (2, 33), (1, 129),
                                         (2, 255), (4, 512), (4, 2048)),
                time_shape=(4, 2048)):
    """K10 within FLASH_TOL and FLASH_ROW_REL of its plain version at the
    qwen3-8b head shape (sizes that straddle its 128-row query blocks and
    96-key tiles among them, q at each of FLASH_Q_SCALES); K10, its plain
    version and the SDPA yardstick timed; the Hopper kernel's registers,
    shared memory and spills as ptxas reported them, none spilled."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import kernel as KA
    from repro_torch.kernels.flash_attn.ref import attention_ref
    H, KH, hd = QWEN_HEADS
    rng = np.random.default_rng(3)

    def operands(B, S, q_scale=0.5):
        return [torch.from_numpy(
            rng.standard_normal((B, S, h, hd)).astype(np.float32) * sc).to(
                device).bfloat16() for h, sc in ((H, q_scale), (KH, 1.0),
                                                 (KH, 1.0))]
    checks, max_err, row_rel = [], 0.0, 0.0
    for B, S in sizes:
        for q_scale in FLASH_Q_SCALES:
            q, k, v = operands(B, S, q_scale)
            for causal in (True, False):
                got = KA.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
                res = flash_errors(got, want)
                checks.append({"B": B, "S": S, "q_scale": q_scale,
                               "causal": causal, **res})
                max_err = max(max_err, res["max_abs_err"])
                row_rel = max(row_rel, res["row_rel_err"])
                if not res["ok"]:
                    emit({"phase": "flash", "checks": checks})
                    raise SystemExit(
                        f"flash_attention differs from its plain version "
                        f"beyond {FLASH_TOL} elementwise or {FLASH_ROW_REL} "
                        f"per row: B={B}, S={S}, q_scale={q_scale}, "
                        f"causal={causal}, {res}")
    smem_bytes = _build.load(KA.LIBRARY).flash_attn_smem_bytes
    smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int], ctypes.c_int
    B, S = time_shape
    q, k, v = operands(B, S)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {
        "ms": graph_ms(lambda: KA.flash_attention(q, k, v, causal=True),
                       iters=20),
        "eager_ms": time_ms(lambda: KA.flash_attention(q, k, v, causal=True),
                            iters=50, warmup=5),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True),
                            iters=3, warmup=1),
        "library_ms": graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True), iters=20),
        **_bf16_bound(*flash_bytes_and_ops(B, S, H, KH, hd))}
    timing["tflops"] = timing["operations"] / timing["ms"] / 1e9
    timing["bound_share"] = timing["bound_ms"] / timing["ms"]
    emit({"phase": "flash", "checks": checks, "tolerance": FLASH_TOL,
          "row_tolerance": FLASH_ROW_REL, "max_abs_err": max_err,
          "row_rel_err": row_rel,
          "timing_shape": {"B": B, "S": S, "H": H, "KH": KH, "hd": hd},
          "timing": timing,
          "ptxas": {**_ptxas_resources(list(ptxas), FLASH_WS_SYMBOL),
                    "dynamic_smem_bytes": smem_bytes(hd)}})
    return {"max_abs_err": max_err, "row_rel_err": row_rel}, timing


def lm_bounds(cfg, B, S, gen):
    """Least times of one prefill of B x S tokens and of one decode step,
    counted from the shapes: prefill by its bf16 matrix and attention
    operations (the last position only is unembedded), decode by the
    bytes of every matrix weight, the token rows of the embedding and the
    valid KV cache at the middle step."""
    D, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    V = cfg.vocab_padded(1)
    per_layer = D * hd * (H + 2 * KH) + H * hd * D + 3 * D * F
    attn_ops = L * flash_bytes_and_ops(B, S, H, KH, hd)[1]
    prefill_ops = 2 * per_layer * L * B * S + attn_ops + 2 * B * D * V
    prefill_bytes = 2 * (per_layer * L + D * V)
    kv_bytes = 2 * 2 * L * B * (S + gen // 2) * KH * hd
    decode_bytes = 2 * (per_layer * L + D * V + B * D) + kv_bytes
    decode_ops = 2 * (per_layer * L + D * V) * B
    return ({"prefill": _bf16_bound(prefill_bytes, prefill_ops),
             "decode_step": _bf16_bound(decode_bytes, decode_ops)})


def _lm_pass(engine, stream):
    """Counts set to 0, the stream served, counts read: every prefill
    launches flash attention once per layer, nothing else launches."""
    import torch
    _reset_counts()
    for p in stream:
        engine.submit(p)
    done = engine.drain()
    torch.cuda.synchronize()
    launches = _expect_launches("lm pass", {
        "flash_attention": engine.cfg.num_layers * len(stream)})
    return done, launches


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def phase_lm(device, batch=4, requests=2, prompt_len=2048, gen=16):
    """qwen3-8b at full width served through K10; the masked path on the
    same params as its reference; times beside bounds."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_arch("qwen3-8b"), attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, prompt_len=prompt_len, gen=gen,
                           device=device, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(engine.params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(engine.params))
    t0 = time.perf_counter()
    engine.warmup(batch)
    warmup_s = time.perf_counter() - t0
    stream = [engine.make_request(batch, seed=100 + i)
              for i in range(requests)]
    done, launches = _lm_pass(engine, stream)
    for r in done:
        toks = r.result["tokens"]
        if toks.shape != (batch, gen) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise SystemExit(f"request {r.rid}: tokens {toks.shape}")

    # per prefill and per decode step, through the engine's own steps
    batch0 = stream[0]
    _reset_counts()
    logits, cache = api.make_prefill(cfg, cache_len=prompt_len + gen)(
        engine.params, batch0)
    torch.cuda.synchronize()
    per_prefill = _expect_launches("one prefill", {
        "flash_attention": cfg.num_layers})
    masked = dataclasses.replace(cfg, attn_impl="masked")
    m_logits, m_cache = api.make_prefill(
        masked, cache_len=prompt_len + gen)(engine.params, batch0)
    prefill_rel = _rel(logits, m_logits)
    same_argmax = float((logits[:, :cfg.vocab_size].argmax(-1)
                         == m_logits[:, :cfg.vocab_size].argmax(-1))
                        .float().mean())
    decode = api.make_decode_step(cfg)
    m_decode = api.make_decode_step(masked)
    feed = torch.from_numpy(done[0].result["tokens"]).to(device)
    step_rel = []
    _reset_counts()
    for t in range(gen):
        tok = {"tokens": feed[:, t:t + 1]}
        logits, cache = decode(engine.params, cache, tok)
        m_logits, m_cache = m_decode(engine.params, m_cache, tok)
        step_rel.append(_rel(logits, m_logits))
    torch.cuda.synchronize()
    _expect_launches("teacher-forced decode", {})
    worst = max([prefill_rel] + step_rel)
    check = {"prefill_rel": prefill_rel, "decode_rel_max": max(step_rel),
             "decode_rel": step_rel, "tolerance": LOGITS_REL,
             "prefill_same_argmax": same_argmax}
    if not worst < LOGITS_REL:
        emit({"phase": "lm", "check": check})
        raise SystemExit(f"K10 prefill disagrees with the masked path: "
                         f"{worst} >= {LOGITS_REL}")
    # the card's time for one decode step at the cache's last position:
    # the step captured in a CUDA graph, so no Python runs between its
    # kernels (the served loop's time less this is the host's share)
    pos = cache["pos"] - 1
    tok = {"tokens": feed[:, -1:]}

    def one_step():
        cache["pos"] = pos
        decode(engine.params, cache, tok)
    decode_graph_ms = graph_ms(one_step, iters=4, replays=5)
    prefill = api.make_prefill(cfg, cache_len=prompt_len + gen)
    profiles = {
        "prefill": device_profile(
            lambda: prefill(engine.params, batch0),
            min(r.result["prefill_s"] for r in done)),
        "decode_step": device_profile(
            one_step, min(r.result["decode_s_per_tok"] for r in done))}
    k10_ms = profiles["prefill"].get("flash_attention_ms")
    if k10_ms is not None and per_prefill["flash_attention"] and not k10_ms:
        emit({"phase": "lm", "profiles": profiles})
        raise SystemExit(
            f"the prefill profile finds no time in K10 though "
            f"{per_prefill['flash_attention']} launches were counted: its "
            f"kernel's name no longer holds {FLASH_SYMBOL!r}")
    del cache, m_cache, logits, m_logits
    rep = engine.report()
    bounds = lm_bounds(cfg, batch, prompt_len, gen)
    out = {"phase": "lm", "arch": cfg.name, "attn_impl": cfg.attn_impl,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": n_params, "param_bytes": param_bytes,
           "batch": batch, "prompt_len": prompt_len, "gen": gen,
           "init_s": init_s, "warmup_s": warmup_s,
           "launches": launches, "launches_per_prefill": per_prefill,
           "launches_per_decode": 0,
           "prefill_s": [r.result["prefill_s"] for r in done],
           "decode_s_per_tok": [r.result["decode_s_per_tok"] for r in done],
           "decode_step_graph_ms": decode_graph_ms,
           "profiles": profiles,
           "bounds": bounds,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "check": check, "sample": done[0].result["tokens"][0].tolist(),
           "report": {k: rep[k] for k in ("mode", "prompt_len", "generated",
                                          "served", "latency")}}
    out["prefill_s_over_bound"] = (min(out["prefill_s"])
                                   / (bounds["prefill"]["bound_ms"] / 1e3))
    out["decode_over_bound"] = (min(out["decode_s_per_tok"])
                                / (bounds["decode_step"]["bound_ms"] / 1e3))
    emit(out)
    return launches


#: substrings of the names of cuBLAS's matrix-product kernels on Hopper
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def device_profile(fn, wall_s, top=6):
    """One call of ``fn`` under ``torch.profiler``: the device's busy time
    (the kernels' own time, summed), split into cuBLAS matrix products,
    the flash-attention kernel and everything else (norms, RoPE, SiLU,
    casts, copies, the plain attention), the kernels that take most of
    it, and the idle share of ``wall_s``, the call's time unprofiled.
    None where the profiler records no device time ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        return {"device_busy_ms": None, "device_idle_share": None}
    busy = sum(r[0] for r in rows)
    split = {"matmul_ms": 0.0, "flash_attention_ms": 0.0, "other_ms": 0.0}
    for ms, name, _ in rows:
        key = ("flash_attention_ms" if FLASH_SYMBOL in name else
               "matmul_ms" if any(g in name for g in GEMM_KERNELS) else
               "other_ms")
        split[key] += ms
    return {"device_busy_ms": busy, "wall_ms": wall_s * 1e3,
            "device_idle_share": max(0.0, 1 - busy / (wall_s * 1e3)),
            **split, "kernels": len(rows),
            "launches": sum(r[2] for r in rows),
            "top": [{"kernel": name[:100], "ms": ms, "calls": n}
                    for ms, name, n in rows[:top]]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _served(done):
    return sum(r.size for r in done)


def _serve_pass(engine, stream, kernel_name):
    """Counts set to 0, the stream served, counts read; returns stats."""
    from repro_torch.kernels.fused.kernel import (launch_counts,
                                                  reset_launch_counts)
    from repro_torch.serving.scheduler import latency_stats
    reset_launch_counts()
    for p in stream:
        engine.submit(p)
    t0 = time.perf_counter()
    done = engine.drain()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if launches[kernel_name] == 0:
        raise SystemExit(f"{kernel_name} was not launched on its pass: "
                         f"{launches}")
    lat = latency_stats(done)["compute_ms"]
    return done, launches, {
        "kernel": kernel_name, "requests": len(done),
        "served": _served(done), "launches": launches,
        "throughput_samples_per_s": _served(done) / wall,
        "compute_ms_p50": lat["p50"], "compute_ms_p99": lat["p99"]}


def _step_split(engine, x_np, reps=20):
    """Median ms of host-to-device copy, launch + compute, and
    device-to-host copy of one step."""
    import torch
    h2d, comp, d2h = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd = torch.from_numpy(x_np).to(engine.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts, pred = engine.backend(xd)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts.cpu().numpy(), pred.cpu().numpy()
        t3 = time.perf_counter()
        h2d.append(t1 - t0)
        comp.append(t2 - t1)
        d2h.append(t3 - t2)
    med = lambda v: float(np.median(v)) * 1e3  # noqa: E731
    return {"rows": int(x_np.shape[0]), "h2d_ms": med(h2d),
            "launch_compute_ms": med(comp), "d2h_ms": med(d2h)}


def _check_against_oracle(engine, done):
    """Every request's counts and predictions equal the float oracle's."""
    import torch
    oracle = engine.backends["float-oracle"]
    for r in done:
        x = torch.from_numpy(np.ascontiguousarray(r.payload)).to(
            engine.device)
        c, p = (t.cpu().numpy() for t in oracle(x))
        if not (np.array_equal(c, r.result[0])
                and np.array_equal(p, r.result[1])):
            raise SystemExit(f"request {r.rid} differs from the oracle")


def phase_serve(device, batch=4096, requests=16, n_train=20000):
    from repro_torch.kernels.autotune import DEFAULT_CONFIG, FusedConfig
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    engine = ServingEngine("dwn-jsc-lg", device=device, max_bucket=batch,
                           n_train=n_train, seed=0)
    startup_s = time.perf_counter() - t0
    if engine.bit_exact != {"fused-packed": True, "packed-eager": True}:
        raise SystemExit(f"startup verification incomplete: "
                         f"{engine.bit_exact}")
    stream = [engine.make_request(batch, seed=1000 + i)
              for i in range(requests)]
    engine.warmup(batch)
    done_k2, launches_k2, k2 = _serve_pass(engine, stream,
                                           "fused_dwn_packed")
    split_k2 = _step_split(engine, stream[0])

    for bucket in engine.scheduler.buckets:
        engine.model.tuned_configs[bucket] = FusedConfig(
            "batch-major", block_b=DEFAULT_CONFIG.block_b)
    engine.warmup(batch)
    done_k1, launches_k1, k1 = _serve_pass(engine, stream,
                                           "fused_dwn_batch_major")
    split_k1 = _step_split(engine, stream[0])
    for a, b in zip(done_k2, done_k1):
        if not (np.array_equal(a.result[0], b.result[0])
                and np.array_equal(a.result[1], b.result[1])):
            raise SystemExit(f"request {a.rid}: the two kernels disagree")
    _check_against_oracle(engine, done_k2[:2])

    engine.model.tuned_configs.clear()
    rng = np.random.default_rng(7)
    ragged = [engine.make_request(int(rng.integers(1, batch + 1)),
                                  seed=2000 + i) for i in range(requests)]
    done_rg, launches_rg, rg = _serve_pass(engine, ragged,
                                           "fused_dwn_packed")
    _check_against_oracle(engine, done_rg)
    emit({"phase": "serve", "arch": "dwn-jsc-lg", "luts": engine.spec.luts,
          "startup_s": startup_s, "bit_exact_vs_oracle": engine.bit_exact,
          "passes": [k2, k1, dict(rg, ragged=True)],
          "step_split": {"fused_dwn_packed": split_k2,
                         "fused_dwn_batch_major": split_k1}})
    # the zero kernel runs before a launch that splits its tiles (the
    # ragged pass's requests of fewer than 132 * 32 rows)
    zeroed = sum(n["fused_dwn_zero"]
                 for n in (launches_k2, launches_k1, launches_rg))
    if not zeroed:
        raise SystemExit("fused_dwn_zero was not launched on the passes")
    return {"fused_dwn_packed": launches_k2["fused_dwn_packed"],
            "fused_dwn_batch_major": launches_k1["fused_dwn_batch_major"],
            "fused_dwn_zero": zeroed}


def phase_cli(device):
    from repro_torch.launch import serve
    seconds = {}
    for argv in (["--arch", "dwn-jsc-lg", "--requests", "4"],
                 ["--arch", "qwen3-8b", "--batch", "2", "--prompt-len",
                  "32", "--gen", "4"]):
        t0 = time.perf_counter()
        serve.main(argv + ["--device", device])
        seconds[argv[1]] = time.perf_counter() - t0
    emit({"phase": "cli", "seconds": seconds})


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    # full float32 in float32 products (the masked attention path's scores)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = max_sm_clock_hz()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count,
          "nvidia_smi": smi, "clocks_max_sm_hz": SM_CLOCK_HZ,
          "torch": torch.__version__,
          "cuda": torch.version.cuda})
    ptxas = phase_build()
    max_err, timing = phase_kernels("cuda")
    stage_err, stage_timing, stage_launches = phase_staged("cuda")
    float_err, float_timing, float_launches = phase_float("cuda")
    flash_err, flash_timing = phase_flash("cuda", ptxas["flash_attn"])
    flash_launches = phase_lm("cuda")
    launches = phase_serve("cuda")
    phase_cli("cuda")

    src = "src/repro_torch/kernels/fused/csrc/fused_dwn.cu"
    replaces = {"fused_dwn_packed": "src/repro/kernels/fused/kernel.py:189",
                "fused_dwn_batch_major":
                    "src/repro/kernels/fused/kernel.py:286"}
    variant_of = {"fused_dwn_packed": "packed",
                  "fused_dwn_batch_major": "batch-major"}
    summary = []
    for name in ("fused_dwn_batch_major", "fused_dwn_packed"):
        t = timing[variant_of[name]]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches[name],
            "equal": True, "max_abs_err": max_err[variant_of[name]],
            "ms": t["ms"], "bucket_ms": t["bucket_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    t = timing["zero"]
    summary.append({
        "name": "fused_dwn_zero", "route": "cuda", "source": src,
        "replaces": replaces["fused_dwn_packed"],
        "part_of": ["fused_dwn_packed", "fused_dwn_batch_major"],
        "launches": launches["fused_dwn_zero"], "equal": True,
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "Tensor.zero_", "B": t["B"]})
    for name, (source, replaced, _) in STAGES.items():
        t = stage_timing[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaced, "launches": stage_launches[name],
            "equal": True, "max_abs_err": stage_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    for name, (source, replaced, _) in FLOAT.items():
        t = float_timing[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaced, "launches": float_launches[name],
            "equal": True, "max_abs_err": float_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": ("two eager calls" if t["library_ms"] is not None
                        else None)})
    t = flash_timing
    summary.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH[0],
        "replaces": FLASH[1], "launches": flash_launches["flash_attention"],
        "equal": False, "tolerance": FLASH_TOL,
        "row_tolerance": FLASH_ROW_REL, **flash_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "scaled_dot_product_attention"})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
