"""qwen3-14b — dense, 40L d_model=5120 40H (GQA kv=8) d_ff=17408,
vocab 151936, qk_norm.  [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    train_microbatches=4,
    source="hf:Qwen/Qwen3-8B; hf",
))
