"""The DWN head on the LM backbone (``dwn-lm-head``): a 16-feature
5-class DWN whose features are pooled from a frozen reduced qwen3-8b
backbone (the ``lm-head`` workload).  Registered as an arch (for report
shapes); its spec preset lives in ``dwn.spec``."""

from .base import ArchConfig
from .registry import register

register(ArchConfig(
    name="dwn-lm-head",
    family="dwn",
    num_layers=1,
    d_model=16,               # pooled backbone features
    num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=5,             # teacher-projection classes
    dwn_luts=50,
    dwn_bits=64,
    dwn_fused=True,
    dwn_datapath="fused-packed",
    source="examples/dwn_head_lm.py promoted (DESIGN.md §6)",
))
