"""Data-driven warm start for DWN training.

The PyTorch counterpart of ``repro.core.warmstart`` (numpy over
``thermometer.encode_np``).  The learnable mapping starts from random
wiring; on tasks whose signal sits in a few dominant cuts the smallest
models are optimization-limited from there.  The warm start:

* **wiring**: the LUTs of class ``c`` see the top thermometer bits by
  |corr| with ``1[y=c]`` (distinct features, near thresholds suppressed)
  and the top bit of each other class;
* **tables**: the empirical majority vote P(y=c | address) > P(y=c) per
  entry;
* **scores**: +``score_bias`` at the chosen wires.

Gradient training then refines both.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import DWNConfig, init_dwn
from .thermometer import encode_np


def bit_label_correlation(bits: np.ndarray, y: np.ndarray,
                          num_classes: int) -> np.ndarray:
    """(n, C_bits) bits, labels -> (C_bits, classes) signed correlations."""
    b = (bits - bits.mean(0)) / (bits.std(0) + 1e-9)
    out = np.zeros((bits.shape[1], num_classes), np.float32)
    for c in range(num_classes):
        t = (y == c).astype(np.float32)
        t = (t - t.mean()) / (t.std() + 1e-9)
        out[:, c] = b.T @ t / len(y)
    return out


def _top_bits(corr_c: np.ndarray, T: int, k: int, *, suppress: int = 20,
              max_per_feature: int = 1) -> list[int]:
    """Top-k bits by |corr|, near thresholds suppressed and picks a
    feature capped, so the wiring spans features."""
    order = np.argsort(-np.abs(corr_c))
    chosen: list[int] = []
    taken: dict[int, list[int]] = {}
    for cand in order:
        f, t = int(cand // T), int(cand % T)
        ts = taken.setdefault(f, [])
        if len(ts) >= max_per_feature:
            continue
        if any(abs(t - t2) <= suppress for t2 in ts):
            continue
        chosen.append(int(cand))
        ts.append(t)
        if len(chosen) >= k:
            break
    return chosen


def warmstart_params(params, buffers, cfg: DWNConfig, x_train: np.ndarray,
                     y_train: np.ndarray, *, score_bias: float = 1.0,
                     sample_cap: int = 10_000):
    """``params`` with the first LUT layer warm-started from (x, y):
    its scores biased at the chosen wires and its tables the majority
    vote.  Returns new (params, buffers) on the params' device."""
    th = buffers["thresholds"].cpu().numpy()
    n_fit = min(sample_cap, x_train.shape[0])
    bits = encode_np(x_train[:n_fit], th)
    y = y_train[:n_fit]
    C, T = cfg.num_classes, cfg.bits_per_feature
    corr = bit_label_correlation(bits, y, C)

    first = params["layers"][0]
    device = first["scores"].device
    scores = first["scores"].detach().cpu().numpy().copy()
    tables = first["tables"].detach().cpu().numpy().copy()
    m, n, _ = scores.shape
    gs = m // C

    own_bits = {c: _top_bits(corr[:, c], T, max(2 * gs, 6))
                for c in range(C)}
    for c in range(C):
        for j in range(gs):
            lut = c * gs + j
            others = [own_bits[o][j % len(own_bits[o])]
                      for o in range(C) if o != c and own_bits[o]]
            own = own_bits[c][2 * j:2 * j + 2] or own_bits[c][:2]
            wires = (own + others)[:n]
            while len(wires) < n:
                wires.append(own_bits[c][len(wires) % len(own_bits[c])])
            for i, w in enumerate(wires):
                scores[lut, i, w] += score_bias
            sel = bits[:, wires]                             # (nfit, n)
            addr = (sel.astype(np.int64)
                    * (1 << np.arange(n))[None, :]).sum(1)
            base = (y == c).mean()
            tab = np.full(2 ** n, -0.5, np.float32)
            for a in np.unique(addr):
                mask = addr == a
                tab[a] = 0.5 if (y[mask] == c).mean() > base else -0.5
            tables[lut] = tab

    layers = [dict(layer) for layer in params["layers"]]
    layers[0] = {"scores": torch.from_numpy(scores).to(device),
                 "tables": torch.from_numpy(tables).to(device)}
    return {"layers": layers}, buffers


def warmstart_dwn(generator: torch.Generator, cfg: DWNConfig,
                  x_train: np.ndarray, y_train: np.ndarray, *,
                  score_bias: float = 1.0, sample_cap: int = 10_000,
                  device="cpu"):
    """(params, buffers) from ``init_dwn(generator, ...)``, the first LUT
    layer warm-started (:func:`warmstart_params`)."""
    params, buffers = init_dwn(generator, cfg, x_train, device=device)
    return warmstart_params(params, buffers, cfg, x_train, y_train,
                            score_bias=score_bias, sample_cap=sample_cap)


__all__ = ["bit_label_correlation", "warmstart_dwn", "warmstart_params"]
