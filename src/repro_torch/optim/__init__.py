"""Optimizer and learning-rate schedules of DWN training."""

from .adam import Adam, AdamState
from .schedule import constant, step_lr, warmup_cosine

__all__ = ["Adam", "AdamState", "constant", "step_lr", "warmup_cosine"]
