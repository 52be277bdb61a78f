"""Learning-rate schedules: StepLR (paper §III), warmup-cosine, constant.

The PyTorch counterpart of ``repro.optim.schedule``.  A schedule maps the
optimizer step counter (an int32 tensor, on the device in training, or a
plain int when probed from the host) to a float32 0-dim learning rate,
computed with the reference's float32 expressions.  Divisors are tensors:
CUDA divides by a host scalar as a product with its reciprocal, which can
put ``step / steps_per_epoch`` just below an epoch boundary.
"""

from __future__ import annotations

import math

import torch


def _f32(v, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr, torch.as_tensor(step).device)


def step_lr(base_lr: float, step_size_epochs: int, gamma: float,
            steps_per_epoch: int):
    """Paper §III: StepLR(step_size=30, gamma=0.1) on epochs.

    lr = base_lr * gamma ** floor(epoch / step_size_epochs), with
    epoch = float32(step) / steps_per_epoch.
    """
    def fn(step):
        s = _step(step)
        dev = s.device
        epoch = s / _f32(float(max(1, steps_per_epoch)), dev)
        k = torch.floor(epoch / _f32(float(step_size_epochs), dev))
        return _f32(base_lr, dev) * _f32(gamma, dev) ** k
    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def fn(step):
        s = _step(step)
        dev = s.device
        warm = s / _f32(max(1.0, float(warmup_steps)), dev)
        prog = torch.clamp(
            (s - warmup_steps)
            / _f32(max(1.0, float(total_steps - warmup_steps)), dev),
            0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(_f32(math.pi, dev) * prog))
        return base_lr * torch.where(s < warmup_steps, warm, cos)
    return fn


__all__ = ["constant", "step_lr", "warmup_cosine"]
