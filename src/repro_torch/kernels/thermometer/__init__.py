"""Thermometer encode, to float32 bits and to packed words: the CUDA
kernels (``kernel.py``), their plain versions (``ref.py``) and the public
ops ``encode`` and ``encode_packed`` (``ops.py``)."""
