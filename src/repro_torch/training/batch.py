"""Multi-seed DWN training on one card.

The PyTorch counterpart of ``repro.training.batch``.  The reference vmaps
its epoch block over a stack of same-shape models in one program and,
with several devices, lays the model axis over a mesh with ``shard_map``.
The port trains the members one after another on one device through the
same :class:`~repro_torch.training.engine.ScanTrainer` (whose captured
step program they share), so member ``i``'s trajectory is a sequential
``train_dwn(seed=seeds[i])`` run's.  ``data_parallel`` is always False:
the mesh waits for ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core.model import DWNConfig, init_dwn
from .engine import ScanTrainer


@dataclasses.dataclass
class BatchTrainOutcome:
    """Results of one multi-seed run.

    Attributes:
      results: per-member ``TrainResult``, in the order of ``seeds``.
      wall_s: wall-clock of the whole run (all members).
      data_parallel: always False (one card, members in sequence).
    """
    results: list
    wall_s: float
    data_parallel: bool


def train_dwn_batch(cfg: DWNConfig, data, *, epochs: int, seeds=(0,),
                    models=None, batch: int = 128, lr: float = 1e-3,
                    sched: str = "steplr",
                    input_frac_bits: int | None = None,
                    data_parallel: bool = False, eval_final: bool = True,
                    device=None) -> BatchTrainOutcome:
    """Train ``len(seeds)`` same-shape DWNs, one after another.

    Args:
      cfg / data / epochs / batch / lr / sched: shared protocol knobs.
      seeds: per-member seed: its init (when ``models`` is None) and its
        permutation stream, as a ``train_dwn(seed=s)`` run's.
      models: optional (params, buffers) warm starts, one per seed.
      input_frac_bits: PEN quantization of the one-time encode.
      data_parallel: must be False; the port has no mesh yet.
      eval_final: evaluate every member after training.
      device: where to train (default ``cuda``).
    """
    if data_parallel:
        raise NotImplementedError(
            "train_dwn_batch on a device mesh is not ported yet (ROADMAP.md "
            "Queue 1 item 9); pass data_parallel=False")
    seeds = list(seeds)
    if models is None:
        models = [init_dwn(torch.Generator().manual_seed(s), cfg,
                           data.x_train) for s in seeds]
    if len(models) != len(seeds):
        raise ValueError("one (params, buffers) per seed")
    from ..core.training import TrainResult
    t0 = time.time()
    trained = []
    for s, (params, buffers) in zip(seeds, models):
        tr = ScanTrainer(cfg, data, batch=batch, lr=lr, sched=sched,
                         seed=s, params=params, buffers=buffers,
                         input_frac_bits=input_frac_bits, device=device)
        trained.append((tr, tr.run_epochs(epochs)))
    wall = time.time() - t0
    results = []
    for tr, losses in trained:
        acc = tr.evaluate() if eval_final else float("nan")
        history = [{"epoch": e, "loss": float(losses[e].mean()),
                    "test_acc": acc if e == epochs - 1 else None,
                    "sec": wall / max(1, epochs) / len(seeds)}
                   for e in range(epochs)]
        results.append(TrainResult(tr.params, tr.buffers, cfg, history,
                                   acc))
    return BatchTrainOutcome(results, wall, False)


__all__ = ["BatchTrainOutcome", "train_dwn_batch"]
