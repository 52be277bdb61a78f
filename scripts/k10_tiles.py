#!/usr/bin/env python3
"""K10's Hopper design at other tile shapes, box widths and block orders,
on one CUDA card.

Builds ``kernels/flash_attn/csrc/flash_attn.cu`` as each entry of
VARIANTS has it (``Shape<hd>``: keys a K/V tile, stages in the ring;
hd 32's box width; ``kKVInL2`` or a fixed group size: how the blocks are
grouped) under the ignored ``build/k10_tiles/``, one ``nvcc`` per
variant, all at once, and reads each Hopper instance's ptxas lines
(registers, spills, wgmma serialisation).  A variant whose key tile has
no ``m64n{keys}k16`` wgmma in the source gets one written in.  Each edit
fails the script if the text it edits is not found once.  Each variant
is checked in a subprocess with a time limit (a deadlocked mbarrier ring
would otherwise hang the call) against the plain version at sizes around
its query blocks and key tiles, causal and not, q scaled by 0.5 and 4,
at the head shapes it changes (HEADS: qwen3-8b's 32 over 8 heads
narrowed to hd 32, granite-moe's 24 over 8 at hd 64, phi3-mini's 32 over
32 at hd 96, qwen3-8b's at hd 128 and recurrentgemma-2b's 10 over 1 at
hd 256; the source as it is at every one).  The instances that compiled
clean and passed are then timed in CUDA graphs at TIME_SHAPES, causal,
in turns (A B B A), beside the first design (mma.sync, through
``flash_attn_mma_launch``, where it has the instance) and
``scaled_dot_product_attention``.
``--variants`` builds only the named ones (``as-is`` always); ``--hds``
checks and times only those head dims.  ``--baseline`` builds another
``flash_attn.cu`` beside them (for example the parent commit's, from
``git show``) and times its Hopper instances in the same turns (the
second turn in the reverse order of the first), and says whether each of
them compiled to the same SASS as the source's (``cuobjdump``).
``--debug-ring`` builds the source as it is with ``-DK10_DEBUG_RING``
(every mbarrier wait bounded, every K and V stage tagged with its tile
and checked by each consumer as it reads and releases it, a trap on a
mismatch) and checks it.  ``--sanitize`` also runs ``compute-sanitizer``
(racecheck, synccheck) over one small launch of each Hopper instance of
the source as it is.  Prints one JSON line (also written to ``--out``)
and the card's name and power limit.

    python3 scripts/k10_tiles.py [--variants "as-is,hd32 4 stages"]
        [--hds 32,256] [--debug-ring] [--sanitize]
        [--baseline OTHER.cu] [--out F]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SOURCE = ROOT / "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu"
OUT = ROOT / "build" / "k10_tiles"
#: each variant's (keys, stages) by head dim, hd 32's box columns (64:
#: 128-byte rows whose columns 32-63 arrive as zeros), blocks an SM and
#: whether its consumers take turns, the bytes of K and
#: V that head_group lets the blocks in flight keep in L2 (1e30 orders
#: the blocks by query block alone at every shape, no groups), or a group
#: size for every shape, GQA included.  The first is the source as it is.
VARIANTS = {
    "as-is": {},
    "v1": {"shapes": {64: (96, 2), 96: (112, 2)}},
    "v2": {"shapes": {64: (112, 2), 96: (96, 3)}},
    "v3": {"shapes": {64: (128, 3), 96: (112, 3)}},
    "hd32 64-col boxes": {"box32": 64},
    "hd32 128 keys 2 stages": {"shapes": {32: (128, 2)}},
    "hd32 128 keys 4 stages": {"shapes": {32: (128, 4)}},
    "hd32 96 keys 4 stages": {"shapes": {32: (96, 4)}},
    "hd32 2 stages": {"shapes": {32: (64, 2)}},
    "hd32 2 blocks": {"blocks32": 2},
    "hd32 2 blocks 2 stages": {"blocks32": 2, "shapes": {32: (64, 2)}},
    "hd32 no turns": {"turns32": False},
    "hd32 2 blocks no turns": {"blocks32": 2, "turns32": False},
    "hd16 4 stages": {"shapes": {16: (64, 4)}},
    "hd16 96 keys 3 stages": {"shapes": {16: (96, 3)}},
    "hd16 128 keys": {"shapes": {16: (128, 2)}},
    "hd16 128 keys 4 stages": {"shapes": {16: (128, 4)}},
    "hd16 192 keys": {"shapes": {16: (192, 2)}},
    "hd16 2 blocks": {"blocks16": 2},
    "hd16 3 blocks": {"blocks16": 3},
    "hd256 64 keys": {"shapes": {256: (64, 2)}},
    "hd256 48 keys 3 stages": {"shapes": {256: (48, 3)}},
    "by query block": {"kv_in_l2": "1e30"},
    "groups of 48": {"group": 48},
    "groups of 24": {"group": 24},
    "groups of 12": {"group": 12},
}
#: head shapes: hd -> (query heads, KV heads)
HEADS = {16: (32, 8), 32: (32, 8), 64: (24, 8), 96: (32, 32), 128: (32, 8),
         256: (10, 1)}
#: the Hopper design's instances and the first design's kept ones
WS_HDS = (16, 32, 64, 96, 128, 256)
MMA_HDS = (16, 32, 64, 96, 256)
#: head dims an instance also runs, checked beside its own: hd 8 reads
#: the hd-16 instance, its columns 8-15 zeros
ALSO_CHECKED = {16: (8,)}
#: (B, S) checked: S on either side of the 128-row query blocks and of
#: 64- to 192-key tiles; at (3, 2000) hd 96's K and V (74 MB) run in
#: groups of 13 (b, h) pairs, the last of 5; at (8, 2048) K and V pass
#: 40 MB at every head shape with several KV heads (hd 128: 67 MB; GQA
#: runs by query block)
CHECK_SIZES = ((1, 1), (2, 63), (1, 65), (1, 95), (2, 97), (1, 111),
               (2, 113), (1, 127), (2, 129), (1, 191), (2, 193), (1, 223),
               (2, 225), (1, 255), (2, 257), (1, 300), (2, 1024), (3, 2000),
               (8, 2048))
#: (B, S, H, KH[, hd]) timed at each instance: the model's heads at 4 x
#: 2048 (hd 128 also at 8 x 2048, the lm_head phase's classify requests,
#: whose K and V pass 40 MB), at hd 16 and 32 qwen3-8b's heads narrowed;
#: at hd 8 (the hd-16 instance), 16, 32 and 256 chip_smoke.py's limits
#: shape, at hd 16 its 65,600 (b, h) pairs of 64 rows
TIME_SHAPES = {16: ((4, 2048, 32, 8), (2, 1000, 8, 2), (2, 1000, 8, 2, 8),
                    (8200, 64, 8, 8)),
               32: ((4, 2048, 32, 8), (2, 1000, 8, 2)),
               64: ((4, 2048, 24, 8),), 96: ((4, 2048, 32, 32),),
               128: ((4, 2048, 32, 8), (8, 2048, 32, 8)),
               256: ((4, 2048, 10, 1), (2, 1000, 8, 2))}
SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
BOX32 = "static constexpr int kBoxCols = HD == 16 ? 16 : HD == 32 ? 32 : 64;"
BLOCKS = "__launch_bounds__(Cfg<HD>::kThreads, 1)"
#: the consumers' turns: each text and the times it occurs
TURNS = (("bar_sync(kTurnBar + c, 256);", 3),
         ("bar_arrive(kTurnBar + 1 - c, 256);", 2),
         ("if (c == 1) bar_arrive(kTurnBar, 256);", 1),
         ("if (c == 0) bar_arrive(kTurnBar + 1, 256);", 1))


def wg_ss(n: int) -> str:
    """The ``wgmma_ss<n>`` specialisation (m64n{n}k16, both operands in
    shared memory) written out, for a key tile the source has none for."""
    regs = ", ".join(f"%{i}" for i in range(n // 2))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    a, b, p = n // 2, n // 2 + 1, n // 2 + 2
    return (f"template <>\n__device__ __forceinline__ void wgmma_ss<{n}>("
            f"float (&d)[{n // 2}], uint64_t da, uint64_t db, int scale_d) "
            f"{{\n  asm volatile(\"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{p}, "
            f"0;\\n\"\n\"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16."
            f"bf16 {{{regs}}}, %{a}, %{b}, p, 1, 1, 0, 0;\\n}}\\n\"\n"
            f": {outs}\n: \"l\"(da), \"l\"(db), \"r\"(scale_d));\n}}\n")


WG_SS_ANCHOR = "// S (64 x kBK) = Q K^T from the descriptors"


def shape_of(text: str, hd: int) -> tuple[int, int]:
    m = re.search(rf"struct Shape<{hd}> {{\n  static constexpr int kBK = "
                  rf"(\d+), kStages = (\d+);", text)
    if m is None:
        raise SystemExit(f"k10_tiles: no Shape<{hd}> in {SOURCE}")
    return int(m.group(1)), int(m.group(2))


def replace_once(text: str, old: str, new: str, times: int = 1) -> str:
    if text.count(old) != times:
        raise SystemExit(f"k10_tiles: {old!r} is not in {SOURCE} "
                         f"{times} times")
    return text.replace(old, new)


def variant_hds(variant) -> tuple[int, ...]:
    """The head dims a variant changes (every one for the source as it
    is and for the block orders)."""
    if "shapes" in variant:
        return tuple(variant["shapes"])
    if {"box32", "blocks32", "turns32"} & set(variant):
        return (32,)
    if "blocks16" in variant:
        return (16,)
    return WS_HDS


def variant_source(variant) -> str:
    text = SOURCE.read_text()
    for hd, shape in variant.get("shapes", {}).items():
        old = "kBK = {}, kStages = {};".format(*shape_of(text, hd))
        head = f"struct Shape<{hd}> {{\n  static constexpr int "
        text = replace_once(text, head + old, head +
                            "kBK = {}, kStages = {};".format(*shape))
        keys = shape[0]
        if f"WG_SS({keys}," not in text:
            text = replace_once(text, WG_SS_ANCHOR,
                                wg_ss(keys) + WG_SS_ANCHOR)
    if "box32" in variant:
        text = replace_once(text, BOX32, BOX32.replace(
            "HD == 32 ? 32 : 64", f"HD == 32 ? {variant['box32']} : 64"))
    for hd in (16, 32):
        if f"blocks{hd}" in variant:
            text = replace_once(text, BLOCKS, BLOCKS.replace(
                ", 1)", f", HD == {hd} ? {variant[f'blocks{hd}']} : 1)"))
    if variant.get("turns32") is False:
        for old, times in TURNS:
            text = replace_once(text, old, "if constexpr (HD != 32) {"
                                f"{old}}}", times)
    if "kv_in_l2" in variant:
        old = re.search(r"constexpr double kKVInL2 = [^;]+;", text)
        if old is None:
            raise SystemExit(f"k10_tiles: no kKVInL2 in {SOURCE}")
        text = replace_once(text, old.group(0), "constexpr double kKVInL2 = "
                            f"{variant['kv_in_l2']};")
    if "group" in variant:
        head = "int head_group(int B, int S, int H, int KH, int hd) {\n"
        text = replace_once(text, head, head + "  if (B > 0) return min("
                            f"B * H, {variant['group']});\n")
    return text


def build(texts: dict[str, tuple[str, tuple[str, ...]]]) -> dict[str, dict]:
    """Each named (source text, extra nvcc flags) built at once; name ->
    {path, ptxas by Hopper instance} or {nvcc_failed}."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (text, flags)) in enumerate(texts.items()):
        src = OUT / f"v{i}.cu"
        src.write_text(text)
        lib = OUT / f"libv{i}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            out[name] = {"nvcc_failed": log[-4000:]}
            continue
        lines = [line.strip() for line in log.splitlines()
                 if "ptxas" in line or "spill" in line]
        ptxas = {hd: cs.ptxas_entry(lines, f"{cs.FLASH_SYMBOL}_wsILi{hd}E")
                 for hd in WS_HDS}
        out[name] = {"path": str(lib), "ptxas": {
            hd: p for hd, p in ptxas.items() if "registers" in p}}
    return out


def clean(res: dict | None) -> bool:
    return (res is not None and not res["warnings"] and "registers" in res
            and not any(res.get("spill_bytes", [1])))


def bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn in ("flash_attn_launch", "flash_attn_mma_launch"):
        if not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = SIGNATURE
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def operands(rng, B, S, H, KH, hd, q_scale=0.5):
    import torch
    return [torch.from_numpy(rng.standard_normal((B, S, h, hd)).astype(
        np.float32) * sc).bfloat16().cuda() for h, sc in
        ((H, q_scale), (KH, 1.0), (KH, 1.0))]


def launcher(lib, fn, q, k, v, out, causal=True):
    import torch
    B, S, H, hd = q.shape
    KH = k.shape[2]
    entry = getattr(lib, fn)

    def call():
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, H, KH, hd, int(causal),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k10_tiles: {fn} at {tuple(q.shape)} failed: "
                             f"CUDA error {err}")
    return call


def check(path: str, sizes, hds, on_cpu: bool) -> int:
    """The library's Hopper instances at ``hds`` against the plain version
    (on the card, or on the CPU so that a sanitizer sees no other
    kernel)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attn.ref import attention_ref
    lib = bind(path)
    rng = np.random.default_rng(5)
    worst = {}
    for inst in hds:
        for hd, (B, S) in ((h, size) for h in (inst, *ALSO_CHECKED.get(
                inst, ())) for size in sizes):
            for q_scale in cs.FLASH_Q_SCALES:
                q, k, v = operands(rng, B, S, *HEADS[inst], hd, q_scale)
                for causal in (True, False):
                    out = torch.empty_like(q)
                    launcher(lib, "flash_attn_launch", q, k, v, out,
                             causal)()
                    torch.cuda.synchronize()
                    dev = "cpu" if on_cpu else "cuda"
                    want = attention_ref(*(t.to(dev).float()
                                           for t in (q, k, v)),
                                         causal=causal)
                    res = cs.flash_errors(out.to(dev), want)
                    if hd < 32:
                        # the row bar of rows under 32 head dims
                        res["ok"] = res["ok"] or (
                            res["row_rel_err"] <= cs.flash_row_bar(hd)
                            and bool(((out.to(dev).float() - want).abs()
                                      <= cs.FLASH_TOL * (1 + want.abs()))
                                     .all()))
                    if not res["ok"]:
                        print(json.dumps({"failed": [hd, B, S, q_scale,
                                                     causal, res]}))
                        return 1
                    w = worst.setdefault(hd, [0.0, 0.0])
                    w[:] = [max(w[0], res["max_abs_err"]),
                            max(w[1], res["row_rel_err"])]
                    del want
    print(json.dumps({"worst": worst}))
    return 0


def checked(path: str, hds, timeout: float = 300.0) -> dict:
    """:func:`check` in a subprocess with a time limit."""
    try:
        proc = subprocess.run(
            [sys.executable, __file__, "--check", path, "--hds",
             ",".join(map(str, hds))], capture_output=True, text=True,
            timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "why": f"timed out after {timeout} s"}
    last = proc.stdout.strip().splitlines()[-1:] or [proc.stderr[-2000:]]
    return {"ok": proc.returncode == 0, "result": last[0]}


def sass(lib: str) -> dict[int, list[str]] | None:
    """Each Hopper instance's SASS in ``lib`` (cuobjdump), addresses and
    encodings dropped; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, hd = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*_wsILi(\d+)E", line)
        if m:
            hd = int(m.group(1))
            out[hd] = []
        elif "Function :" in line:
            hd = None
        elif hd is not None:
            code = re.sub(r"/\*[^*]*\*/", "", line)
            # the anonymous namespace's name holds a hash of its file
            code = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN_",
                          code).strip()
            if code:
                out[hd].append(code)
    return out


def sass_equal(base: str, mine: str, hds) -> dict | None:
    """Whether each Hopper instance ``base`` has compiled to the same
    instructions in ``mine``, else the instruction counts and the first
    pair that differs (None without cuobjdump)."""
    a, b = sass(base), sass(mine)
    if a is None or b is None:
        return None
    out = {}
    for hd in hds:
        x, y = a.get(hd, []), b.get(hd, [])
        first = next((i for i, (u, w) in enumerate(zip(x, y)) if u != w),
                     None if len(x) == len(y) else min(len(x), len(y)))
        out[hd] = True if first is None else {
            "instructions": [len(x), len(y)],
            "first_difference": [x[first:first + 1], y[first:first + 1]]}
    return out


def sanitizer() -> str | None:
    found = shutil.which("compute-sanitizer")
    cand = Path("/usr/local/cuda/bin/compute-sanitizer")
    return found or (str(cand) if cand.exists() else None)


def sanitize(path: str, timeout: float = 240.0) -> dict:
    """compute-sanitizer's racecheck and synccheck over one B = 1, S = 300
    launch, causal and not, q scales 0.5 and 4, of each Hopper instance."""
    tool = sanitizer()
    if tool is None:
        return {"tool": None, "why": "no compute-sanitizer on this machine"}
    out = {"tool": tool}
    for check_tool in ("racecheck", "synccheck"):
        cmd = [tool, "--tool", check_tool, sys.executable, __file__,
               "--check-small", path]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired:
            out[check_tool] = {"why": f"timed out after {timeout} s"}
            continue
        text = (proc.stdout + proc.stderr).splitlines()
        out[check_tool] = {
            "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "summary": [line for line in text if "ERROR SUMMARY" in line
                        or "hazard" in line.lower()][:20],
            "tail": text[-25:]}
    return out


def main() -> int:
    import torch
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--check")
    ap.add_argument("--check-small")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS "
                    "to build (default: all)")
    ap.add_argument("--hds", help="comma-separated head dims to check and "
                    "time (default: all of WS_HDS)")
    ap.add_argument("--debug-ring", action="store_true")
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--baseline", help="another flash_attn.cu (for example "
                    "the parent commit's) to time beside at the head dims "
                    "where it has a Hopper instance")
    ap.add_argument("--out", help="also write the result, indented, here")
    args = ap.parse_args()
    hds = (tuple(int(h) for h in args.hds.split(",")) if args.hds
           else WS_HDS)
    if args.check:
        return check(args.check, CHECK_SIZES, hds, on_cpu=False)
    if args.check_small:
        return check(args.check_small, ((1, 300),), WS_HDS, on_cpu=True)
    if not torch.cuda.is_available():
        print("k10_tiles: no CUDA card", file=sys.stderr)
        return 3
    cs.SM_CLOCK_HZ = cs.max_sm_clock_hz()
    names = ["as-is"] + [n for n in (args.variants.split(",")
                                     if args.variants else VARIANTS)
                         if n != "as-is"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    texts = {name: (variant_source(VARIANTS[name]), ()) for name in names}
    if args.baseline:
        texts["baseline"] = (Path(args.baseline).read_text(), ())
    if args.debug_ring:
        texts["debug ring"] = (SOURCE.read_text(), ("-DK10_DEBUG_RING",))
    t0 = time.perf_counter()
    built = build(texts)
    build_s = time.perf_counter() - t0
    # the head dims each build is checked and timed at
    mine = {name: [hd for hd in (WS_HDS if name in ("baseline", "debug ring")
                                 else variant_hds(VARIANTS[name]))
                   if hd in hds and hd in b.get("ptxas", {})]
            for name, b in built.items()}
    for name, b in built.items():
        if "path" not in b:
            continue
        if name != "as-is" and not built["as-is"].get("check", {}).get("ok"):
            b["check"] = {"ok": False, "why": "not run: as-is failed"}
            continue
        b["check"] = checked(b["path"], mine[name])
    rng = np.random.default_rng(0)
    calls, bounds = {}, {}
    for inst in hds:
        for shape in TIME_SHAPES[inst]:
            B, S, H, KH = shape[:4]
            hd = shape[4] if len(shape) > 4 else inst
            at = f"hd{hd} {B}x{S} {H}/{KH}"
            bounds[at] = cs.flash_bound(B, S, H, KH, hd)
            q, k, v = operands(rng, B, S, H, KH, hd)
            out = torch.empty_like(q)
            for name, b in built.items():
                if (name != "debug ring" and "path" in b
                        and b["check"]["ok"] and inst in mine[name]
                        and clean(b["ptxas"].get(inst))):
                    calls[(at, name)] = launcher(
                        bind(b["path"]), "flash_attn_launch", q, k, v, out)
            if inst in MMA_HDS and "path" in built["as-is"]:
                calls[(at, "first design")] = launcher(
                    bind(built["as-is"]["path"]), "flash_attn_mma_launch",
                    q, k, v, out)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            calls[(at, "sdpa")] = (
                lambda qt=qt, kt=kt, vt=vt:
                torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
    runs = {key: [] for key in calls}
    for order in (list(calls), list(calls)[::-1]):   # in turns: A B B A
        for key in order:
            runs[key].append(cs.graph_ms(calls[key], iters=20))
    ms = {}
    for (at, name), times in runs.items():
        ms.setdefault(at, {})[name] = times
    tflops = {at: {name: bounds[at]["operations"] / min(t) / 1e9
                   for name, t in by.items()} for at, by in ms.items()}
    result = {"k10_tiles_ms": ms, "tflops": tflops, "bounds": bounds,
              "variants": {name: {k: b[k] for k in ("ptxas", "check",
                                                    "nvcc_failed")
                                  if k in b} for name, b in built.items()},
              "edits": {name: VARIANTS[name] for name in names},
              "heads": HEADS, "build_s": round(build_s, 1)}
    if args.sanitize and "path" in built["as-is"]:
        result["sanitizer"] = sanitize(built["as-is"]["path"])
    if "path" in built.get("baseline", {}) and "path" in built["as-is"]:
        result["sass_equal_to_baseline"] = sass_equal(
            built["baseline"]["path"], built["as-is"]["path"],
            built["baseline"]["ptxas"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps(result, default=str), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
