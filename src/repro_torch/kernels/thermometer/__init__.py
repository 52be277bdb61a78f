"""Packed thermometer encode: the CUDA kernel (``kernel.py``), its plain
version (``ref.py``) and the public op ``encode_packed`` (``ops.py``)."""
