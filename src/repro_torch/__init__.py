"""PyTorch/CUDA port of the DWN reproduction (``repro``).

Mirrors ``repro``'s layout module for module; imports torch and numpy and
never JAX or ``repro``.  The hot path runs hand-written CUDA kernels for
Hopper (``kernels/fused/csrc``), built with ``nvcc`` on first launch.
Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
