"""PTQ bit-width search and fine-tuning: the DWN-PEN / DWN-PEN+FT recipe.

The PyTorch counterpart of ``repro.core.quantize``.  Paper §III:
thresholds are quantized to signed fixed point (1, n); n is lowered until
the quantized model no longer meets its baseline accuracy (DWN-PEN).
Fine-tuning (10 epochs, Adam lr=1e-3, StepLR(30, 0.1)) then recovers
accuracy at lower widths (DWN-PEN+FT).
"""

from __future__ import annotations

import dataclasses

from .model import DWNConfig, eval_accuracy_hard, freeze
from .thermometer import quantize_fixed_point, total_bits_for_frac
from .training import TrainResult, train_dwn


@dataclasses.dataclass
class PTQResult:
    total_bits: int            # 1 + frac bits (the paper quotes the total)
    frac_bits: int
    accuracy: float
    sweep: list                # [(total_bits, acc)], descending


def ptq_bitwidth_search(params, buffers, cfg: DWNConfig, data,
                        baseline_acc: float, *, max_frac: int = 12,
                        tol: float = 0.002,
                        verbose: bool = True) -> PTQResult:
    """DWN-PEN: the smallest (1, n) meeting ``baseline_acc`` within
    ``tol``, on the hard path."""
    sweep, best = [], None
    for frac in range(max_frac, 0, -1):
        frozen = freeze(params, buffers, cfg, input_frac_bits=frac)
        acc = eval_accuracy_hard(frozen, data.x_test, data.y_test,
                                 device=buffers["thresholds"].device)
        tb = total_bits_for_frac(frac)
        sweep.append((tb, acc))
        if verbose:
            print(f"  PTQ {tb:2d}-bit: acc={acc:.4f} "
                  f"(baseline {baseline_acc:.4f})", flush=True)
        if acc + tol >= baseline_acc:
            best = PTQResult(tb, frac, acc, sweep)
        else:
            break
    if best is None:        # even max_frac failed; report it anyway
        tb, acc = sweep[0]
        best = PTQResult(tb, max_frac, acc, sweep)
    return best


@dataclasses.dataclass
class FTResult:
    total_bits: int
    frac_bits: int
    accuracy: float
    result: TrainResult
    sweep: list


def finetune_bitwidth_search(params, buffers, cfg: DWNConfig, data,
                             baseline_acc: float, *, start_frac: int,
                             min_frac: int = 3, epochs: int = 10,
                             tol: float = 0.002, seed: int = 1,
                             verbose: bool = True,
                             device=None) -> FTResult:
    """DWN-PEN+FT: lower the width, fine-tune ``epochs`` at each level,
    keep the smallest width whose fine-tuned accuracy meets the
    baseline.  Trains on ``device`` (default ``cuda``)."""
    best, sweep = None, []
    for frac in range(start_frac, min_frac - 1, -1):
        q_buffers = {"thresholds": quantize_fixed_point(
            buffers["thresholds"], frac)}
        res = train_dwn(cfg, data, epochs=epochs, lr=1e-3, seed=seed,
                        params=params, buffers=q_buffers,
                        input_frac_bits=frac, sched="steplr",
                        verbose=False, device=device)
        frozen = freeze(res.params, res.buffers, cfg, input_frac_bits=frac)
        acc = eval_accuracy_hard(frozen, data.x_test, data.y_test,
                                 device=res.buffers["thresholds"].device)
        tb = total_bits_for_frac(frac)
        sweep.append((tb, acc))
        if verbose:
            print(f"  FT {tb:2d}-bit: acc={acc:.4f} "
                  f"(baseline {baseline_acc:.4f})", flush=True)
        if acc + tol >= baseline_acc:
            best = FTResult(tb, frac, acc, res, sweep)
        else:
            break
    if best is None:
        tb, acc = sweep[0]
        best = FTResult(tb, start_frac, acc, None, sweep)
    return best


__all__ = ["FTResult", "PTQResult", "finetune_bitwidth_search",
           "ptq_bitwidth_search"]
