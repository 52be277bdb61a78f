"""Soft (training-path) accuracy of a DWN.

The PyTorch counterpart of ``repro.training.evaluator``.  The reference
caches one compiled evaluator per (cfg, input_frac_bits); PyTorch runs
eagerly and compiles nothing, so there is nothing to cache and the
evaluator is a plain function.
"""

from __future__ import annotations

import torch

from ..core.classifier import accuracy
from ..core.model import DWNConfig, apply_train
from ..core.thermometer import quantize_fixed_point


@torch.no_grad()
def soft_accuracy(params, buffers, cfg: DWNConfig, x: torch.Tensor,
                  y: torch.Tensor,
                  input_frac_bits: int | None = None) -> torch.Tensor:
    """float32 accuracy of the training forward on ``x`` (PEN features
    quantized first) against labels ``y``."""
    if input_frac_bits is not None:
        x = quantize_fixed_point(x, input_frac_bits)
    return accuracy(apply_train(params, buffers, cfg, x), y)


__all__ = ["soft_accuracy"]
