"""LUT-layer evaluation, on float32 bits and on packed words: the CUDA
kernels (``kernel.py``), their plain versions (``ref.py``) and the public
ops ``evaluate`` and ``evaluate_packed`` (``ops.py``)."""
