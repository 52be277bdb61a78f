"""Popcount and first-argmax classify, on float32 bits and on packed
words: the CUDA kernels (``kernel.py``), their plain versions (``ref.py``)
and the public ops ``classify`` and ``classify_packed`` (``ops.py``)."""
