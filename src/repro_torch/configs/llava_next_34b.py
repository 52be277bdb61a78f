"""llava-next-34b — VLM, 60L d_model=7168 56H (GQA kv=8) d_ff=20480,
vocab 64000; anyres tiling frontend is a STUB per the assignment:
input_specs() provides precomputed (B, num_patches, d_model) patch
embeddings prepended to the text sequence.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
    num_patches=2880,         # anyres 2x2 grid + base, 576 each
    train_microbatches=8,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))
