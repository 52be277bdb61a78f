"""Hand-written CUDA kernels for Hopper, each beside a plain PyTorch
version of the same function (``ref.py``).  ``fused`` holds the two fused
DWN kernels of the serving path; ``_build`` compiles ``csrc/*.cu`` with
``nvcc`` on first launch (never on import)."""
