"""qwen2-7b — dense, 28L d_model=3584 28H (GQA kv=4) d_ff=18944,
vocab 152064, QKV bias.  [arXiv:2407.10671; hf]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    train_microbatches=4,
    source="arXiv:2407.10671; hf",
))
