"""MNIST workload: real digits when available, seeded synthetic fallback.

The port's copy of the reference's ``repro.workloads.mnist``: the same
arguments give byte-identical splits in both packages.  The DWN papers
anchor their efficiency claims on MNIST-class image workloads, so this is
the registry's second entry — 14x14 = 196 features (28x28 real images are
2x2 mean-pooled down to the schema), 10 classes.

Data resolution order:

1. A local npz at ``$REPRO_MNIST`` or ``~/.cache/repro/mnist.npz`` with
   ``x_train/y_train/x_test/y_test`` arrays (the standard Keras
   ``mnist.npz`` layout), read only when it already exists.
2. Otherwise: a deterministic synthetic fallback — per-class stroke
   prototypes drawn once from a fixed master seed (split-invariant
   ground truth, same scheme as ``data/jsc.py``), per-sample pixel
   shift + gain jitter + noise, labels by construction.  Deterministic
   per ``(n_train, n_test, seed)``.

The port never downloads: the reference's ``REPRO_MNIST_DOWNLOAD=1``
branch is not ported, and when that variable is set the port warns that
it does not download and goes on with the synthetic fallback.

Both paths normalize features to [-1, 1) with *train-split* statistics
via the shared ``normalize_to_unit``, exactly like JSC, so downstream
thermometer encoding sees the same input contract.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np

from ..core.model import DWNConfig
from ..data.jsc import JSCData, normalize_to_unit
from .base import Workload, register_workload

SIDE = 14
NUM_FEATURES = SIDE * SIDE
NUM_CLASSES = 10

#: MNIST DWN tiers. ``lut_counts[-1]`` must divide by 10 classes; the
#: sm/md/lg widths bracket the LUT budgets of the 8-bit MLP comparison
#: points (tinyML-style accelerators) at a fraction of the cost.
MNIST_PRESETS = {
    "mnist-sm": DWNConfig(num_features=NUM_FEATURES, bits_per_feature=8,
                          lut_counts=(100,), num_classes=NUM_CLASSES),
    "mnist-md": DWNConfig(num_features=NUM_FEATURES, bits_per_feature=8,
                          lut_counts=(500,), num_classes=NUM_CLASSES),
    "mnist-lg": DWNConfig(num_features=NUM_FEATURES, bits_per_feature=16,
                          lut_counts=(2000,), num_classes=NUM_CLASSES),
}


# -- synthetic fallback ------------------------------------------------------

class _SyntheticDigits:
    """Fixed per-class stroke prototypes (master-seeded, split-invariant)."""

    def __init__(self):
        master = np.random.default_rng(20260)
        yy, xx = np.mgrid[0:SIDE, 0:SIDE].astype(np.float64) / (SIDE - 1)
        protos = []
        for _ in range(NUM_CLASSES):
            img = np.zeros((SIDE, SIDE))
            for _stroke in range(4):
                cx, cy = master.uniform(0.15, 0.85, 2)
                sx, sy = master.uniform(0.06, 0.22, 2)
                rho = master.uniform(-0.5, 0.5)
                amp = master.uniform(0.6, 1.0)
                dx, dy = (xx - cx) / sx, (yy - cy) / sy
                img += amp * np.exp(
                    -0.5 * (dx * dx - 2 * rho * dx * dy + dy * dy)
                    / (1 - rho * rho))
            protos.append(img / img.max())
        self.protos = np.stack(protos)                    # (10, SIDE, SIDE)


_DIGITS: _SyntheticDigits | None = None


def _digits() -> _SyntheticDigits:
    global _DIGITS
    if _DIGITS is None:
        _DIGITS = _SyntheticDigits()
    return _DIGITS


def _sample_synthetic(n: int, rng: np.random.Generator):
    t = _digits()
    y = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    imgs = t.protos[y]                                    # (n, SIDE, SIDE)
    # per-sample jitter: +-1 pixel shift, gain, additive pixel noise
    shifts = rng.integers(-1, 2, (n, 2))
    gain = rng.uniform(0.8, 1.2, (n, 1, 1))
    noise = rng.normal(0.0, 0.08, imgs.shape)
    out = np.empty_like(imgs)
    for s in (-1, 0, 1):
        for u in (-1, 0, 1):
            m = (shifts[:, 0] == s) & (shifts[:, 1] == u)
            if m.any():
                out[m] = np.roll(imgs[m], (s, u), axis=(1, 2))
    x = np.clip(out * gain + noise, 0.0, 1.5).astype(np.float32)
    return x.reshape(n, NUM_FEATURES), y


# -- real data path ----------------------------------------------------------

def _cache_path() -> Path:
    env = os.environ.get("REPRO_MNIST")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro" / "mnist.npz"


def _pool_28_to_14(x: np.ndarray) -> np.ndarray:
    """2x2 mean-pool 28x28 images down to the 14x14 feature schema."""
    x = x.reshape(-1, 14, 2, 14, 2).mean(axis=(2, 4))
    return x.reshape(-1, NUM_FEATURES)


def _load_real(n_train: int, n_test: int, seed: int):
    """Real MNIST from the npz cache; None when it is not there."""
    path = _cache_path()
    if not path.exists():
        if os.environ.get("REPRO_MNIST_DOWNLOAD") == "1":
            warnings.warn(f"REPRO_MNIST_DOWNLOAD is set, but the PyTorch "
                          f"port does not download MNIST; place the npz "
                          f"at {path} to use the real digits.  Using the "
                          f"synthetic fallback", stacklevel=3)
        return None
    try:
        with np.load(path) as z:
            xtr, ytr = z["x_train"], z["y_train"]
            xte, yte = z["x_test"], z["y_test"]
    except Exception as e:                                # noqa: BLE001
        warnings.warn(f"MNIST cache {path} unreadable ({e}); using the "
                      f"synthetic fallback", stacklevel=3)
        return None
    rng = np.random.default_rng(seed)
    itr = rng.permutation(len(xtr))[:n_train]
    ite = rng.permutation(len(xte))[:n_test]
    xtr = _pool_28_to_14(xtr[itr].astype(np.float32) / 255.0)
    xte = _pool_28_to_14(xte[ite].astype(np.float32) / 255.0)
    return xtr, ytr[itr].astype(np.int32), xte, yte[ite].astype(np.int32)


# -- loader ------------------------------------------------------------------

def load_mnist(n_train: int = 20000, n_test: int = 5000,
               seed: int = 0) -> JSCData:
    real = _load_real(n_train, n_test, seed)
    if real is not None:
        x_tr, y_tr, x_te, y_te = real
    else:
        rng = np.random.default_rng(seed)
        x_tr, y_tr = _sample_synthetic(n_train, rng)
        x_te, y_te = _sample_synthetic(n_test, rng)
    x_tr, lo, hi = normalize_to_unit(x_tr)
    x_te, _, _ = normalize_to_unit(x_te, lo, hi)
    return JSCData(x_tr, y_tr, x_te, y_te)


MNIST = register_workload(Workload(
    name="mnist",
    num_features=NUM_FEATURES,
    num_classes=NUM_CLASSES,
    loader=lambda n_train, n_test, seed=0: load_mnist(n_train, n_test,
                                                      seed=seed),
    presets=MNIST_PRESETS,
    description=("MNIST digits, 2x2-pooled to 14x14 (196 features, 10 "
                 "classes); the real npz when it is cached, seeded "
                 "synthetic stroke digits otherwise"),
))

__all__ = ["MNIST", "MNIST_PRESETS", "load_mnist"]
