"""DWN training engine.

* ``engine``    — :class:`ScanTrainer` / :func:`train_dwn_scan`: the split
  encoded once on the device, every minibatch step one replay of a
  captured CUDA graph (eager on the CPU), losses fetched once per block.
* ``batch``     — :func:`train_dwn_batch`: several seeds, one after
  another on one card.
* ``evaluator`` — the soft accuracy ``core.training.eval_soft`` streams.
* ``reference`` — the per-minibatch loop with the textbook STE, the
  engine's parity oracle.

``repro_torch.core.training.train_dwn`` runs the engine.
"""

from .batch import BatchTrainOutcome, train_dwn_batch
from .engine import (ScanTrainer, StepProgram, encode_dataset,
                     epoch_permutation, step_program, train_dwn_scan)
from .evaluator import soft_accuracy
from .reference import ReferenceTrainer, train_dwn_reference

__all__ = [
    "BatchTrainOutcome", "ReferenceTrainer", "ScanTrainer", "StepProgram",
    "encode_dataset", "epoch_permutation", "soft_accuracy", "step_program",
    "train_dwn_batch", "train_dwn_reference", "train_dwn_scan",
]
