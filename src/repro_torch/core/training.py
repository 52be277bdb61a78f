"""DWN training (paper §III protocol): the front end of the engine.

The PyTorch counterpart of ``repro.core.training``.  ``train_dwn`` runs
the engine of :mod:`repro_torch.training.engine` (on CUDA every minibatch
step is one replay of a captured CUDA graph; losses are fetched once per
epoch block); ``eval_soft`` streams the test split through the training
forward in batches of 4096 and averages the batch accuracies weighted by
their sizes on the host, in float64, as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import DWNConfig


@dataclasses.dataclass
class TrainResult:
    params: dict
    buffers: dict
    cfg: DWNConfig
    history: list
    soft_test_acc: float


def eval_soft(params, buffers, cfg: DWNConfig, x: np.ndarray,
              y: np.ndarray, input_frac_bits: int | None = None,
              batch: int = 4096) -> float:
    """Soft (training-path) accuracy on (x, y), on the device the
    thresholds live on."""
    from ..training.evaluator import soft_accuracy
    device = buffers["thresholds"].device
    accs, ns = [], []
    for i in range(0, x.shape[0], batch):
        xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch],
                                                   np.float32)).to(device)
        yb = torch.from_numpy(np.asarray(y[i:i + batch], np.int64)).to(
            device)
        accs.append(float(soft_accuracy(params, buffers, cfg, xb, yb,
                                        input_frac_bits)))
        ns.append(xb.shape[0])
    return float(np.average(accs, weights=ns))


def train_dwn(cfg: DWNConfig, data, *, epochs: int = 30, batch: int = 128,
              lr: float = 1e-3, seed: int = 0, params=None, buffers=None,
              input_frac_bits: int | None = None, sched: str = "steplr",
              verbose: bool = True, eval_every: int = 1,
              device=None) -> TrainResult:
    """Train (or fine-tune, if params are given) a DWN on ``data``.

    ``eval_every=0`` evaluates only after the last epoch and runs every
    epoch as one block (one host fetch of the losses).  The caller's
    params and buffers are copied, never written.  Runs on ``device``
    (default ``cuda``; raises without a card).
    """
    from ..training.engine import train_dwn_scan
    return train_dwn_scan(cfg, data, epochs=epochs, batch=batch, lr=lr,
                          seed=seed, params=params, buffers=buffers,
                          input_frac_bits=input_frac_bits, sched=sched,
                          eval_every=eval_every, verbose=verbose,
                          device=device)


__all__ = ["TrainResult", "eval_soft", "train_dwn"]
