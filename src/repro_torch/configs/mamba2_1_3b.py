"""mamba2-1.3b — attention-free SSD (state-space duality), 48L d_model=2048,
ssm_state=128, headdim=64 (d_inner = 2*d_model = 4096 => 64 heads),
vocab 50280.  [arXiv:2405.21060; unverified]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
    train_microbatches=4,
    source="arXiv:2405.21060; unverified",
))
