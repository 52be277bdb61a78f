"""JSC as a registry workload: the loader is ``data.jsc.load_jsc`` and the
preset tiers are ``JSC_PRESETS`` (Table I model sizes)."""

from __future__ import annotations

from ..core.model import JSC_PRESETS
from ..data.jsc import NUM_CLASSES, NUM_FEATURES, load_jsc
from .base import Workload, register_workload


def _load(n_train: int, n_test: int, seed: int = 0):
    return load_jsc(n_train, n_test, seed=seed)


JSC = register_workload(Workload(
    name="jsc",
    num_features=NUM_FEATURES,
    num_classes=NUM_CLASSES,
    loader=_load,
    presets=dict(JSC_PRESETS),
    description=("Jet Substructure Classification surrogate (16 features, "
                 "5 jet classes; seeded synthetic stand-in for Duarte et "
                 "al. 2018, see data.jsc)"),
))

__all__ = ["JSC"]
