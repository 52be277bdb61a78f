#!/usr/bin/env python3
"""K10's per-row error beside the bf16 algorithm's own, on one CUDA card.

At each shape of SHAPES (B, S, H, KH, hd), causal and not, q, k and v as
``tests/test_torch_gpu.py`` draws them (a seeded CUDA generator, q scaled
by 0.5, bf16), holds four outputs against the exact attention in float32
(``attention_ref``): the wrapper's kernel (the instance ``instance_for``
names), the kept mma.sync design (``flash_attn_mma_launch``),
``scaled_dot_product_attention`` and the bf16 algorithm in plain PyTorch
(``chip_smoke.flash_rounded``: P and the output rounded to bf16).  For
each it prints the largest per-row error (max |diff| over the row's
largest |exact|, the bar ``chip_smoke.flash_row_bar`` holds), the largest
|diff|, the rows over 2e-2 and the worst row's largest |exact|.  One JSON
line a shape and causal flag, then the card's name and power limit.

    python3 scripts/k10_row_errors.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: (B, S, H, KH, hd, seed): the 65,600 (b, h) pairs of 64 rows at hd 8
#: and 16 (the card test's seeds), the limits shape and qwen3-8b's heads
#: at hd 8
SHAPES = ((8200, 64, 8, 8, 8, 608), (8200, 64, 8, 8, 16, 616),
          (2, 1000, 8, 2, 8, 608), (4, 2048, 32, 8, 8, 608))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels._launch import bind
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn.ref import attention_ref
    if not torch.cuda.is_available():
        print("k10_row_errors: no CUDA card", file=sys.stderr)
        return 3
    lib = bind(FK.LIBRARY, FK._SIGNATURES)
    for B, S, H, KH, hd, seed in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (t.bfloat16() for t in (
            torch.randn((B, S, H, hd), generator=g, device="cuda") * 0.5,
            torch.randn((B, S, KH, hd), generator=g, device="cuda"),
            torch.randn((B, S, KH, hd), generator=g, device="cuda")))
        for causal in (True, False):
            want = attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
            mma = torch.zeros_like(q)
            err = lib.flash_attn_mma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mma.data_ptr(), B,
                S, H, KH, hd, int(causal),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"flash_attn_mma_launch failed: {err}")
            outs = {
                "kernel": FK.flash_attention(q, k, v, causal=causal),
                "mma": mma,
                "sdpa": torch.nn.functional.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in (q, k, v)),
                    is_causal=causal, enable_gqa=True).transpose(1, 2),
                "rounded": cs.flash_rounded(q, k, v, causal)}
            res = {}
            for name, t in outs.items():
                d = (t.float() - want).abs()
                scale = want.abs().amax(-1)
                row = d.amax(-1) / scale.clamp_min(1e-30)
                res[name] = {
                    "row_rel": float(row.max()), "max_abs": float(d.max()),
                    "rows_over_2e-2": int((row > 2e-2).sum()),
                    "worst_row_max_want": float(
                        scale.flatten()[int(row.argmax())])}
            print(json.dumps({"shape": [B, S, H, KH, hd], "causal": causal,
                              "instance": FK.instance_for(hd), **res}),
                  flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
