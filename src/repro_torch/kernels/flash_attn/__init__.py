"""Flash attention: the CUDA kernel (``kernel.py``), its plain version
(``ref.py``) and the public op ``attend`` (``ops.py``), in the model's
grouped-query layout (B, S, heads, head_dim)."""
