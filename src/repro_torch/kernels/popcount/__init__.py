"""Masked popcount and first-argmax classify on packed words: the CUDA
kernel (``kernel.py``), its plain version (``ref.py``) and the public op
``classify_packed`` (``ops.py``)."""
