"""Multi-seed DWN training: on one device, or data-parallel over the
ranks of a process group.

The PyTorch counterpart of ``repro.training.batch``.  The reference vmaps
its epoch block over a stack of same-shape models in one program and,
with several devices, lays the model axis over the ``("data",)`` mesh
with ``shard_map``.  The port trains a rank's members one after another
through the same :class:`~repro_torch.training.engine.ScanTrainer` (whose
captured step program they share), so member ``i``'s trajectory is a
sequential ``train_dwn(seed=seeds[i])`` run's.  With
``data_parallel=True`` and an initialised process group of ``n`` ranks
that divides the members, rank ``r`` trains members ``r*k … r*k+k-1``
(``k = n_models / n``) and every rank ends with every member, gathered in
seed order.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core.model import DWNConfig, init_dwn
from ..launch.mesh import make_data_mesh
from ..optim.adam import map_tree
from ..sharding.partition import axis_size
from .engine import ScanTrainer


@dataclasses.dataclass
class BatchTrainOutcome:
    """Results of one multi-seed run.

    Attributes:
      results: per-member ``TrainResult``, in the order of ``seeds``.
      wall_s: wall-clock of the whole run (all members).
      data_parallel: whether the members were split over the ranks of
        a process group (else all ran here, in sequence).
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
      data_parallel: split the members over the ranks of the initialised
        process group when there are several and they divide the
        members; every rank returns every member.
      eval_final: evaluate every member after training.
      device: where to train (default ``cuda``).
    """
    seeds = list(seeds)
    if models is not None and len(models) != len(seeds):
        raise ValueError("one (params, buffers) per seed")
    n_ranks, rank = 1, 0
    if data_parallel:
        mesh = make_data_mesh(device_type=torch.device(
            "cuda" if device is None else device).type)
        n = axis_size(mesh, "data")
        if n > 1 and len(seeds) % n == 0:
            n_ranks, rank = n, mesh.get_local_rank("data")
    k = len(seeds) // n_ranks
    mine = range(rank * k, (rank + 1) * k)
    inits = [models[i] if models is not None else init_dwn(
        torch.Generator().manual_seed(seeds[i]), cfg, data.x_train)
        for i in mine]
    from ..core.training import TrainResult
    t0 = time.time()
    trained = []
    for i, (params, buffers) in zip(mine, inits):
        tr = ScanTrainer(cfg, data, batch=batch, lr=lr, sched=sched,
                         seed=seeds[i], params=params, buffers=buffers,
                         input_frac_bits=input_frac_bits, device=device)
        trained.append((tr, tr.run_epochs(epochs)))
    runs = []
    for tr, losses in trained:
        acc = tr.evaluate() if eval_final else float("nan")
        runs.append((tr.params, tr.buffers,
                     [float(losses[e].mean()) for e in range(epochs)], acc))
    if n_ranks > 1:
        runs = _gather_runs(runs, n_ranks, mesh)
    wall = time.time() - t0
    results = []
    for params, buffers, losses, acc in runs:
        history = [{"epoch": e, "loss": losses[e],
                    "test_acc": acc if e == epochs - 1 else None,
                    "sec": wall / max(1, epochs) / len(seeds)}
                   for e in range(epochs)]
        results.append(TrainResult(params, buffers, cfg, history, acc))
    return BatchTrainOutcome(results, wall, n_ranks > 1)


def _gather_runs(runs: list, n_ranks: int, mesh) -> list:
    """Every rank's (params, buffers, losses, acc) runs on every rank, in
    rank order (= seed order), the tensors on this rank's device."""
    import torch.distributed as dist
    dev = runs[0][1]["thresholds"].device
    host = [(map_tree(lambda t: t.detach().cpu(), p),
             map_tree(lambda t: t.detach().cpu(), b), losses, acc)
            for p, b, losses, acc in runs]
    every = [None] * n_ranks
    dist.all_gather_object(every, host, group=mesh.get_group("data"))
    return [(map_tree(lambda t: t.to(dev), p),
             map_tree(lambda t: t.to(dev), b), losses, acc)
            for part in every for p, b, losses, acc in part]


__all__ = ["BatchTrainOutcome", "train_dwn_batch"]
