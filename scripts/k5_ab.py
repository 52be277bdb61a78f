#!/usr/bin/env python3
"""Where the time of K5's tile kernel goes, on one CUDA card.

Builds ``kernels/popcount/csrc/popcount.cu`` as it is and with lines
replaced (each variant below takes a part of the tile kernel out or
changes one decision), under the ignored ``build/k5_ab/``, one ``nvcc``
per variant, all at once.  Then times each variant's tile kernel in CUDA
graphs at the served buckets on random words under contiguous class
groups of dwn-jsc-lg (W = 75 words, C = 5) and MNIST-lg (W = 63, C = 10),
with the plan's warps and, as it is, with 1, 2 and 4, beside the kept
first design (the rows kernel) and one launch of the zero kernel on one
element (the launch floor), in turns, twice.  The variants that compute
the whole function are held to the plain version first, at every warp
count.  Prints one JSON line and the card's name and power limit.

    python3 scripts/k5_ab.py
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SOURCE = ROOT / "src/repro_torch/kernels/popcount/csrc/popcount.cu"
OUT = ROOT / "build" / "k5_ab"
BUCKETS = (1, 64, 1024, 4096)
#: (W words, C classes) of contiguous class groups: dwn-jsc-lg (2400
#: LUTs, 5 classes) and MNIST-lg (2000 LUTs, 10 classes)
SHAPES = ((75, 5), (63, 10))

LIVE = "    if (!((live >> c) & 1u)) continue;\n"
POPC = ("      for (int j = 0; j < kChunk; ++j) "
        "s += __popc(x[j] & mc[c0 + j]);\n")
CHUNKED = ("    for (int c0 = 0; c0 < n; c0 += kChunk) {\n"
           "      uint32_t x[kChunk];  "
           "// words past n are 0 and count nothing\n"
           "#pragma unroll\n"
           "      for (int j = 0; j < kChunk; ++j)"
           " x[j] = c0 + j < n ? row[c0 + j] : 0u;\n"
           "#pragma unroll\n"
           "      for (int j = 0; j < kChunk; ++j)"
           " s += __popc(x[j] & mc[c0 + j]);\n"
           "    }\n")
STAGED = "  cp_async_wait_all();\n  __syncthreads();\n"
ENTRY = "  extern __shared__ __align__(16) unsigned char sm[];\n"
#: name -> (replacements, whether it computes the whole function)
VARIANTS = {
    "as-is": ((), True),
    # every class's popcounts, live or not
    "no class test": (((LIVE, ""),), True),
    # a test of each mask word (per word and class) instead of the warp's
    # one test of its classes
    "test per word": (((POPC, "      for (int j = 0; j < kChunk; ++j) {\n"
                               "        const uint32_t m = mc[c0 + j];\n"
                               "        if (m != 0u) s += __popc(x[j] & m);\n"
                               "      }\n"),), True),
    # the words one at a time (unrolled by 4), no chunk of 16 in registers
    "word loop": (((CHUNKED, "#pragma unroll 4\n"
                             "    for (int j = 0; j < n; ++j)"
                             " s += __popc(row[j] & mc[j]);\n"),), True),
    # chunks of 16, but no popcount of the words past n
    "guarded chunk": (((POPC, "      for (int j = 0; j < kChunk; ++j)\n"
                              "        if (c0 + j < n)"
                              " s += __popc(x[j] & mc[c0 + j]);\n"),), True),
    # each lane reads its row's words from global memory, no tile staged
    "rows from global": (
        (("  if (p.pitch == W && (reinterpret_cast<uintptr_t>(src) & 15) "
          "== 0) {\n", "  if (W < 0) {\n"),
         ("    for (int g = tid; g < nr * W; g += blockDim.x) {\n",
          "    for (int g = tid; g < 0; g += blockDim.x) {\n"),
         ("x[j] = c0 + j < n ? row[c0 + j] : 0u;",
          "x[j] = c0 + j < n ? __ldg(src + min(lane, nr - 1) * W + w0 + c0"
          " + j) : 0u;")), True),
    # 16 warps a block (the plan takes at most 8)
    "16 warps": ((("constexpr int kMaxTileWarps = 8;",
                   "constexpr int kMaxTileWarps = 16;"),), True),
    # no popcounts: staging, the class test, the stores and the argmax
    "no words": (((LIVE, "    continue;\n"),), False),
    # the staging alone
    "staging only": (((STAGED, STAGED + "  if (p.B > 0) return;\n"),),
                     False),
    # a launch of the same shape that does nothing
    "empty": (((ENTRY, ENTRY + "  if (p.B > 0) return;\n"),), False),
}
#: warps a block, besides the plan's, timed for the source as it is
WARPS = (1, 2, 4)
#: variants timed at other warps than the plan's
VARIANT_WARPS = {"16 warps": 16}


def variant_source(edits) -> str:
    """The source with ``edits`` made, its shared header included by an
    absolute path (the variants build under build/k5_ab/)."""
    text = SOURCE.read_text().replace(
        '#include "../../csrc/tiles.cuh"',
        f'#include "{SOURCE.parents[2] / "csrc" / "tiles.cuh"}"')
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k5_ab: {old!r} is not in {SOURCE} once")
        text = text.replace(old, new)
    return text


def build() -> dict[str, ctypes.CDLL]:
    """Every variant built at once into build/k5_ab/."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        src = OUT / f"v{i}.cu"
        src.write_text(variant_source(edits))
        lib = OUT / f"libv{i}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k5_ab: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].popcount_classify_packed_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.core import bitpack as bp
    from repro_torch.kernels.fused import kernel as KF
    from repro_torch.kernels.popcount import kernel as KP
    from repro_torch.kernels.popcount import ref as RP
    if not torch.cuda.is_available():
        print("k5_ab: no CUDA card", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    libs = build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    calls, plans = {}, {}
    for W, C in SHAPES:
        words = bp.to_word_pattern(torch.from_numpy(rng.integers(
            0, 2 ** 32, (max(BUCKETS), W), dtype=np.uint64).astype(
            np.int64))).cuda()
        masks = bp.to_word_pattern(bp.group_masks(32 * W - 32 * W % C, C,
                                                  "cuda"))
        counts = torch.empty((max(BUCKETS), C), device="cuda")
        idx = torch.empty((max(BUCKETS),), dtype=torch.int32, device="cuda")
        plan = KP.plan_popcount_classify_packed(W, C)
        plans[f"{W}x{C}"] = dataclasses.asdict(plan)

        def tile(name, B, warps, W=W, C=C, words=words, masks=masks,
                 counts=counts, idx=idx, smem=plan.smem_bytes):
            fn = libs[name].popcount_classify_packed_launch

            def call():
                err = fn(words.data_ptr(), B, W, masks.data_ptr(), C,
                         counts.data_ptr(), idx.data_ptr(), warps, smem,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"k5_ab: {name} failed: CUDA error "
                                     f"{err}")
            return call

        ref = RP.popcount_classify_packed_plain(words, masks)
        for name, (_, whole) in VARIANTS.items():
            for warps in ((VARIANT_WARPS.get(name, plan.warps), *WARPS)
                          if whole else ()):
                counts.fill_(-1.0)
                tile(name, max(BUCKETS), warps)()
                torch.cuda.synchronize()
                if not (torch.equal(counts, ref[0])
                        and torch.equal(idx, ref[1])):
                    raise SystemExit(f"k5_ab: {name} at {warps} warps "
                                     f"differs from the plain version "
                                     f"({W} words, {C} classes)")
        for B in BUCKETS:
            for name in VARIANTS:
                calls[(f"{W}x{C}", name, B)] = tile(
                    name, B, VARIANT_WARPS.get(name, plan.warps))
            for warps in WARPS:
                calls[(f"{W}x{C}", f"as-is, {warps} warps", B)] = tile(
                    "as-is", B, warps)
            calls[(f"{W}x{C}", "first design", B)] = cs.rows_kernel(
                KP.LIBRARY, KP._SIGNATURES,
                "popcount_classify_packed_rows_launch", words.data_ptr(), B,
                W, masks.data_ptr(), C, counts.data_ptr(), idx.data_ptr())
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    calls[("", "launch floor", 1)] = lambda: KF.fused_dwn_zero(one)
    runs = {key: [] for key in calls}
    for _ in range(2):                       # in turns, twice
        for key, fn in calls.items():
            runs[key].append(cs.graph_ms(fn))
    ms = {}
    for (shape, name, B), times in runs.items():
        ms.setdefault(shape, {}).setdefault(name, {})[B] = times
    print(json.dumps({"k5_ab_ms": ms, "plans": plans,
                      "build_s": round(build_s, 1)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
