"""mixtral-8x7b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336, vocab 32000,
MoE 8 experts top-2, sliding-window attention (W=4096).
[arXiv:2401.04088; hf]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    swa_window=4096,
    num_experts=8,
    top_k=2,
    train_microbatches=4,
    source="arXiv:2401.04088; hf",
))
