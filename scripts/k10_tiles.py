#!/usr/bin/env python3
"""K10's Hopper design at head_dim 64 and 96 at other tile shapes and
block orders, on one CUDA card.

Builds ``kernels/flash_attn/csrc/flash_attn.cu`` as each entry of
VARIANTS has it (``Shape<64>`` and ``Shape<96>``: keys a K/V tile,
stages in the ring; ``kKVInL2`` or a fixed group size: how the blocks are
grouped) under the ignored ``build/k10_tiles/``, one ``nvcc`` per
variant, all at once, and reads each Hopper instance's ptxas lines
(registers, spills, wgmma serialisation).  A variant with 112-key tiles
gets the ``m64n112k16`` wgmma that the source does not carry.  Each edit
fails the script if the text it edits is not found once.  Each variant is checked in a
subprocess with a time limit (a deadlocked mbarrier ring would otherwise
hang the call) against the plain version at sizes around its query
blocks and key tiles, causal and not, q scaled by 0.5 and 4, at
granite-moe's (24 over 8 heads, hd 64), phi3-mini's (32 over 32, hd 96)
and qwen3-8b's (32 over 8, hd 128) head shapes.  The instances that
compiled clean and passed are then timed in CUDA graphs at TIME_SHAPES
(B = 4, S = 2048 at each head shape; at hd 128 also B = 8, the
lm_head phase's classify requests, whose K and V pass 40 MB),
causal, in turns, twice, beside the first design (mma.sync, through
``flash_attn_mma_launch``) and ``scaled_dot_product_attention``.
``--variants`` builds only the named ones (``as-is`` always).
``--baseline`` builds another ``flash_attn.cu`` beside them (for example
the parent commit's, from ``git show``) and times its hd-128 instance in
the same turns.  ``--sanitize`` also runs ``compute-sanitizer``
(racecheck, synccheck) over one small launch of each Hopper instance of
the source as it is.  Prints one JSON line (also written to ``--out``)
and the card's name and power limit.

    python3 scripts/k10_tiles.py [--variants "as-is,by query block"]
        [--sanitize] [--baseline OTHER.cu] [--out F]
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
#: each variant's (keys, stages) at hd 64 and at hd 96, or the bytes of K
#: and V that head_group lets the blocks in flight keep in L2 (1e30 orders
#: the blocks by query block alone at every shape, no groups), or a group
#: size for every shape, GQA included.  The first is the source as it is.
VARIANTS = {
    "as-is": {},
    "v1": {"shapes": ((96, 2), (112, 2))},
    "v2": {"shapes": ((112, 2), (96, 3))},
    "v3": {"shapes": ((128, 3), (112, 3))},
    "by query block": {"kv_in_l2": "1e30"},
    "groups of 48": {"group": 48},
    "groups of 24": {"group": 24},
    "groups of 12": {"group": 12},
}
#: head shapes: hd -> (query heads, KV heads)
HEADS = {64: (24, 8), 96: (32, 32), 128: (32, 8)}
#: (B, S) checked: S on either side of the 128-row query blocks and of
#: 96-, 112- and 128-key tiles; at (3, 2000) hd 96's K and V (74 MB) run
#: in groups of 13 (b, h) pairs, the last of 5; at (8, 2048) K and V pass
#: 40 MB at every head shape (hd 128: 67 MB; GQA runs by query block)
CHECK_SIZES = ((1, 1), (2, 63), (1, 95), (2, 97), (1, 111), (2, 113),
               (1, 127), (2, 129), (1, 191), (2, 193), (1, 223), (2, 225),
               (1, 255), (2, 257), (1, 300), (2, 1024), (3, 2000), (8, 2048))
#: (B, S) timed at each head dim
TIME_SHAPES = {64: ((4, 2048),), 96: ((4, 2048),),
               128: ((4, 2048), (8, 2048))}
#: the m64n112k16 wgmma a 112-key tile needs, and where it goes
WG_SS_112 = "WG_SS(112, 56, 57, 58, WG_REGS56, WG_D56)\n"
WG_SS_ANCHOR = "WG_SS(128, 64, 65, 66, WG_REGS64, WG_D64)\n"
SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def shape_of(text: str, hd: int) -> tuple[int, int]:
    m = re.search(rf"struct Shape<{hd}> {{\n  static constexpr int kBK = "
                  rf"(\d+), kStages = (\d+);", text)
    if m is None:
        raise SystemExit(f"k10_tiles: no Shape<{hd}> in {SOURCE}")
    return int(m.group(1)), int(m.group(2))


def replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"k10_tiles: {old!r} is not in {SOURCE} once")
    return text.replace(old, new)


def variant_source(variant) -> str:
    text = SOURCE.read_text()
    for hd, shape in zip((64, 96), variant.get("shapes", ())):
        old = "kBK = {}, kStages = {};".format(*shape_of(text, hd))
        head = f"struct Shape<{hd}> {{\n  static constexpr int "
        text = replace_once(text, head + old, head +
                            "kBK = {}, kStages = {};".format(*shape))
    if any(keys == 112 for keys, _ in variant.get("shapes", ())):
        text = replace_once(text, WG_SS_ANCHOR, WG_SS_112 + WG_SS_ANCHOR)
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


def build(names, baseline: str | None) -> dict[str, dict]:
    """The variants ``names`` (and ``baseline``, another flash_attn.cu
    whose Hopper design takes hd 128 alone) built at once; name -> {path,
    shapes, ptxas}."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {name: variant_source(VARIANTS[name]) for name in names}
    if baseline:
        texts["baseline"] = Path(baseline).read_text()
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        src = OUT / f"v{i}.cu"
        src.write_text(text)
        lib = OUT / f"libv{i}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            out[name] = {"nvcc_failed": log[-4000:]}
            continue
        lines = [line.strip() for line in log.splitlines()
                 if "ptxas" in line or "spill" in line]
        if name == "baseline":
            out[name] = {"path": str(lib), "ptxas": {128: cs.ptxas_entry(
                lines, f"{cs.FLASH_SYMBOL}_ws")}}
            continue
        out[name] = {"path": str(lib), "ptxas": {
            hd: cs.ptxas_entry(lines, f"{cs.FLASH_SYMBOL}_wsILi{hd}E")
            for hd in HEADS},
            "shapes": {hd: shape_of(texts[name], hd) for hd in (64, 96)}}
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


def operands(rng, B, S, hd, q_scale=0.5):
    import torch
    H, KH = HEADS[hd]
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


def check(path: str, sizes, on_cpu: bool) -> int:
    """The library's Hopper instances against the plain version (on the
    card, or on the CPU so that a sanitizer sees no other kernel)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attn.ref import attention_ref
    lib = bind(path)
    rng = np.random.default_rng(5)
    worst = {}
    for hd in HEADS:
        for B, S in sizes:
            for q_scale in cs.FLASH_Q_SCALES:
                q, k, v = operands(rng, B, S, hd, q_scale)
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
                    if not res["ok"]:
                        print(json.dumps({"failed": [hd, B, S, q_scale,
                                                     causal, res]}))
                        return 1
                    w = worst.setdefault(hd, [0.0, 0.0])
                    w[:] = [max(w[0], res["max_abs_err"]),
                            max(w[1], res["row_rel_err"])]
    print(json.dumps({"worst": worst}))
    return 0


def checked(path: str, timeout: float = 180.0) -> dict:
    """:func:`check` in a subprocess with a time limit."""
    try:
        proc = subprocess.run(
            [sys.executable, __file__, "--check", path], capture_output=True,
            text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "why": f"timed out after {timeout} s"}
    last = proc.stdout.strip().splitlines()[-1:] or [proc.stderr[-2000:]]
    return {"ok": proc.returncode == 0, "result": last[0]}


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
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--baseline", help="another flash_attn.cu (for example "
                    "the parent commit's) to time at hd 128 beside")
    ap.add_argument("--out", help="also write the result, indented, here")
    args = ap.parse_args()
    if args.check:
        return check(args.check, CHECK_SIZES, on_cpu=False)
    if args.check_small:
        return check(args.check_small, ((1, 300),), on_cpu=True)
    if not torch.cuda.is_available():
        print("k10_tiles: no CUDA card", file=sys.stderr)
        return 3
    names = ["as-is"] + [n for n in (args.variants.split(",")
                                     if args.variants else VARIANTS)
                         if n != "as-is"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    t0 = time.perf_counter()
    built = build(names, args.baseline)
    build_s = time.perf_counter() - t0
    for name, b in built.items():
        if "path" not in b:
            continue
        if name != "as-is" and not built["as-is"].get("check", {}).get("ok"):
            b["check"] = {"ok": False, "why": "not run: as-is failed"}
            continue
        b["check"] = checked(b["path"])
    rng = np.random.default_rng(0)
    calls = {}
    for hd, shapes in TIME_SHAPES.items():
        for B, S in shapes:
            at = f"hd{hd} {B}x{S}"
            q, k, v = operands(rng, B, S, hd)
            out = torch.empty_like(q)
            for name, b in built.items():
                if ("path" in b and b["check"]["ok"]
                        and clean(b["ptxas"].get(hd))
                        and (hd != 128
                             or "shapes" not in VARIANTS.get(name, {}))):
                    calls[(at, name)] = launcher(
                        bind(b["path"]), "flash_attn_launch", q, k, v, out)
            if hd != 128 and "path" in built["as-is"]:
                calls[(at, "first design")] = launcher(
                    bind(built["as-is"]["path"]), "flash_attn_mma_launch",
                    q, k, v, out)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            calls[(at, "sdpa")] = (
                lambda qt=qt, kt=kt, vt=vt:
                torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
    runs = {key: [] for key in calls}
    for _ in range(2):                       # in turns, twice
        for key, fn in calls.items():
            runs[key].append(cs.graph_ms(fn, iters=20))
    ms = {}
    for (at, name), times in runs.items():
        ms.setdefault(at, {})[name] = times
    ops = {f"hd{hd} {B}x{S}": cs.flash_bytes_and_ops(B, S, *HEADS[hd], hd)[1]
           for hd, shapes in TIME_SHAPES.items() for B, S in shapes}
    tflops = {at: {name: ops[at] / min(t) / 1e9 for name, t in by.items()}
              for at, by in ms.items()}
    result = {"k10_tiles_ms": ms, "tflops": tflops, "variants": {
        name: {k: b[k] for k in ("shapes", "ptxas", "check", "nvcc_failed")
               if k in b} for name, b in built.items()},
        "edits": {name: VARIANTS[name] for name in names},
        "heads": HEADS, "build_s": round(build_s, 1)}
    if args.sanitize and "path" in built["as-is"]:
        result["sanitizer"] = sanitize(built["as-is"]["path"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
