"""recurrentgemma-2b — hybrid RG-LRU + local attention (1 attn : 2 rec),
26L d_model=2560 10H (MQA kv=1) d_ff=7680, vocab 256000, lru_width=2560,
local window 2048.  [arXiv:2402.19427; hf]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,            # pattern: [rec, rec, attn] x 8 + [rec, rec]
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10_000.0,
    tie_embeddings=True,
    lru_width=2560,
    local_window=2048,
    train_microbatches=2,
    source="arXiv:2402.19427; hf",
))
