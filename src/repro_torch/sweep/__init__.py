"""Encoding-aware design-space exploration, on the card.

The PyTorch counterpart of ``repro.sweep``.  The paper's headline result —
thermometer encoding can dominate DWN hardware cost (up to 3.20x LUTs on
JSC) — means encoding choices must be co-designed with the rest of the
accelerator.  ``repro_torch.sweep`` walks that design space end to end: a
grid over {JSC preset, TEN/PEN, thermometer bits, threshold placement}
runs through one shared pipeline measuring accuracy (packed hard
inference), FPGA cost (``hw.cost``), and the card's throughput (the fused
packed kernel K2 and the serving engine), emitting one ``SweepResult``
table, Pareto fronts, and the regenerated paper artifacts.

Entry points: ``python -m repro_torch.launch.sweep --grid paper`` (CLI),
:func:`run_grid` (library), and ``repro_torch.sweep.artifacts``.
"""

from . import artifacts
from .autodesign import (AutodesignChoice, AutodesignError, choose_design,
                         emit_verified)
from .cache import SweepCache, config_hash, point_key
from .executor import ChaosSpec, ExecutorSettings, run_grid_parallel
from .grid import GRIDS, SweepPoint, load_grid
from .pipeline import SweepRunner, SweepSettings, run_grid
from .results import PointResult, SweepResult, pareto_front

__all__ = [
    "AutodesignChoice", "AutodesignError", "ChaosSpec", "ExecutorSettings",
    "GRIDS", "PointResult", "SweepCache", "SweepPoint", "SweepResult",
    "SweepRunner", "SweepSettings", "artifacts", "choose_design",
    "config_hash", "emit_verified", "load_grid", "pareto_front",
    "point_key", "run_grid", "run_grid_parallel",
]
