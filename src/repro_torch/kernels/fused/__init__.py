"""Fused DWN kernels: encode -> LUT layer(s) -> masked popcount -> first
argmax in one launch (``kernel.py``), their plain versions (``ref.py``) and
the serving-side operand prep (``ops.py``)."""
