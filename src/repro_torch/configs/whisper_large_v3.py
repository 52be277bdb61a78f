"""whisper-large-v3 — enc-dec, 32 encoder + 32 decoder layers, d_model=1280,
20H (MHA), d_ff=5120, vocab 51866.  Conv audio frontend is a STUB per the
assignment: input_specs() provides precomputed (B, frames, d_model) frame
embeddings.  [arXiv:2212.04356; unverified]
"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,            # decoder layers
    enc_layers=32,
    enc_frames=1500,          # 30 s of audio after the conv stub
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,          # MHA
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    norm_eps=1e-5,
    train_microbatches=2,
    source="arXiv:2212.04356; unverified",
))
