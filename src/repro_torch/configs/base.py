"""Config system: one frozen dataclass describing an architecture, and
the input shapes of the model zoo.

The port's own copy of the reference's ``ArchConfig`` (all fields, so a
config crosses between the two packages field for field),
``round_up``, ``ShapeConfig`` with the LM shapes (``SHAPES``) and the
DWN ones (``DWN_SHAPES``), and ``cell_supported``.  ``reduced()``
derives the CPU test variant of the same family (same code paths, tiny
dims).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    swa_window: Optional[int] = None  # sliding-window attention (Mixtral)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    source: str = ""                 # provenance tag from the assignment

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_ep: bool = False             # expert parallelism over "model"
                                     # (experts padded to the TP degree)

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # --- hybrid (RecurrentGemma: RG-LRU + local attention, 1 attn : 2 rec) ---
    lru_width: int = 0
    local_window: int = 0

    # --- enc-dec (Whisper; frontend is a stub producing frame embeddings) ---
    enc_layers: int = 0
    enc_frames: int = 1500

    # --- VLM (LLaVA-NeXT; anyres tiling stub producing patch embeddings) ---
    num_patches: int = 0

    # --- DWN (the paper's own models; family="dwn") ---
    dwn_luts: int = 0                # m (LUT-layer width)
    dwn_bits: int = 200              # thermometer bits per feature (T) —
                                     # the encoder *resolution*, first-class
                                     # so repro.sweep can sweep it
    dwn_encoding: str = "distributive"  # threshold placement: "distributive"
                                        # (quantile) | "uniform" | "gaussian"
    dwn_fused: bool = False          # fused (VMEM-blocked) serving datapath
    dwn_datapath: str = "corner"     # "corner" (baseline) | "gather" (opt)
    dwn_grouping: str = "contig"     # "contig" (paper Fig.1) | "strided"
                                     # (shard-aligned popcount; opt)

    # --- training defaults ---
    attn_impl: str = "masked"        # "masked" flash | "tri" (block-triangular)
    attn_scores_bf16: bool = False   # bf16 score tiles (halves flash traffic)
    attn_chunk: int = 1024           # flash kv-chunk
    remat: bool = True
    train_microbatches: int = 4      # gradient-accumulation for train_4k
                                     # (sized so remat'd residuals fit HBM)

    # ------------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def vocab_padded(self, tp: int = 16) -> int:
        return round_up(self.vocab_size, max(256, tp))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.swa_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper via its decoder)

    def num_params(self, tp: int = 16) -> int:
        """Approximate *real* (unpadded) parameter count."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim_
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "dwn":
            m, n, T = self.dwn_luts, 6, self.dwn_bits
            return m * n * D * T + m * 2 ** n + D * T
        if self.family == "ssm":
            di = self.ssm_expand * D
            nh = di // self.ssm_headdim
            per = (D * (2 * di + 2 * self.ssm_ngroups * self.ssm_state + nh)
                   + di * D + 2 * nh + di)
            return L * per + emb
        attn = D * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * D
        if self.family == "moe":
            ffn = self.num_experts * 3 * D * F + D * self.num_experts
        else:
            ffn = 3 * D * F
        per = attn + ffn + 2 * D
        if self.family == "hybrid":
            n_attn = L // 3
            n_rec = L - n_attn
            W = self.lru_width
            rec = 2 * D * W + W * D + 7 * W  # proj in x2, out, lru gates/conv
            per = n_attn * (attn + 3 * D * F + 2 * D) \
                + n_rec * (rec + 3 * D * F + 2 * D)
            return per + emb
        total = L * per + emb
        if self.family == "encdec":
            enc_per = D * hd * 3 * self.num_heads + self.num_heads * hd * D \
                + 2 * D * F + 2 * D
            total += self.enc_layers * enc_per
            total += L * (attn + 2 * D)      # cross-attention blocks
        return total

    def num_active_params(self) -> int:
        """Params touched per token (MoE: top_k experts)."""
        if self.family != "moe":
            return self.num_params()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim_
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        attn = D * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * D
        ffn = self.top_k * 3 * D * F + D * self.num_experts
        return L * (attn + ffn + 2 * D) + emb

    # ------------------------------------------------------------------

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2 if self.family != "hybrid" else 3),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads
            < self.num_heads else 4,
            head_dim=16,
            d_ff=96 if self.family != "moe" else 32,
            vocab_size=251,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            lru_width=64 if self.lru_width else 0,
            local_window=8 if self.local_window else 0,
            swa_window=16 if self.swa_window else None,
            enc_layers=2 if self.enc_layers else 0,
            enc_frames=12 if self.enc_layers else 1500,
            num_patches=6 if self.num_patches else 0,
            attn_chunk=16,
        )


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM pool (seq_len x global_batch).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    num_microbatches: int = 1        # gradient-accumulation (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

#: shapes of the paper's own DWN models (family="dwn"): samples =
#: seq_len x global_batch feature vectors; the FPGA accelerator's
#: one-sample-per-cycle throughput maps to huge-batch streaming.
DWN_SHAPES = {
    "dwn_train_1m": ShapeConfig("dwn_train_1m", 4096, 256, "train",
                                num_microbatches=4),
    "dwn_serve_1m": ShapeConfig("dwn_serve_1m", 4096, 256, "prefill"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a valid cell?  Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 524k dense KV decode is the "
                       "quadratic regime this shape excludes (DESIGN.md §6)")
    return True, ""


__all__ = ["ArchConfig", "DWN_SHAPES", "SHAPES", "ShapeConfig",
           "cell_supported", "round_up"]
