"""Packed LUT-layer evaluation: the CUDA kernel (``kernel.py``), its plain
version (``ref.py``) and the public op ``evaluate_packed`` (``ops.py``)."""
