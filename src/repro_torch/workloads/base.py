"""Typed workload registry: name -> loader + feature schema + presets.

A :class:`Workload` bundles what the rest of the port needs to know about
a dataset: feature count, class count, the seeded train/test loader and
the DWN preset tiers that fit its geometry.  Loaders return a split with
``x_train`` / ``y_train`` / ``x_test`` / ``y_test``: float32 features
normalized to [-1, 1) with train-split statistics, int32 labels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..core.model import DWNConfig


@dataclasses.dataclass(frozen=True)
class Workload:
    """One registered dataset.

    Attributes:
      name: registry key (``"jsc"``).
      num_features: feature count F the encoder sees.
      num_classes: label count C (``lut_counts[-1] % C == 0``).
      loader: ``(n_train, n_test, seed) -> split``, deterministic per
        arguments.
      presets: tier name -> base :class:`DWNConfig`.
      description: one-line provenance note.
    """

    name: str
    num_features: int
    num_classes: int
    loader: Callable
    presets: dict[str, DWNConfig]
    description: str = ""

    def load(self, n_train: int, n_test: int, seed: int = 0):
        return self.loader(n_train, n_test, seed)


_REGISTRY: dict[str, Workload] = {}


def register_workload(wl: Workload) -> Workload:
    """Register a workload; re-registering a name is an error."""
    if wl.name in _REGISTRY:
        raise ValueError(f"workload {wl.name!r} already registered")
    for tier, cfg in wl.presets.items():
        if (cfg.num_features, cfg.num_classes) != (wl.num_features,
                                                   wl.num_classes):
            raise ValueError(f"preset {tier!r} does not match workload "
                             f"{wl.name!r}'s geometry")
    _REGISTRY[wl.name] = wl
    return wl


def _ensure_loaded() -> None:
    from . import jsc  # noqa: F401  (self-registers)


def get_workload(name: str) -> Workload:
    """Resolve a registered workload; ``KeyError`` lists the known names."""
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown workload {name!r}; registered workloads: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_workloads() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def load_workload(name: str, n_train: int, n_test: int, seed: int = 0):
    """One-call split loader: ``get_workload(name).load(...)``."""
    return get_workload(name).load(n_train, n_test, seed)


__all__ = [
    "Workload", "get_workload", "list_workloads", "load_workload",
    "register_workload",
]
