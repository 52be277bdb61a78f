"""qwen3-8b — dense, 36L d_model=4096 32H (GQA kv=8) d_ff=12288,
vocab 151936, qk_norm.  [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    train_microbatches=4,
    source="hf:Qwen/Qwen3-8B; hf",
))
