"""Thermometer encoding: distributive (percentile), uniform and gaussian.

The PyTorch counterpart of ``repro.core.thermometer``:

* features are normalized to [-1, 1) before encoding;
* *distributive* placement puts the T thresholds of each feature at the
  (i+1)/(T+1) quantiles of that feature's training distribution;
* *uniform* placement spaces thresholds evenly over [-1, 1);
* *gaussian* placement puts them at the normal quantiles of a per-feature
  N(mean, std) fit.

Threshold fitting is numpy (float64 ``np.quantile``), copied from the
reference so the same training rows give the same float32 thresholds.  The
encode path is plain tensor code: bit ``t`` of feature ``f`` is
``x_f > th[f, t]``, compared in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bitpack import PackedBits


@dataclasses.dataclass(frozen=True)
class ThermometerSpec:
    """Static description of a thermometer encoder bank.

    Attributes:
      num_features: F, number of real-valued input features.
      bits_per_feature: T, thresholds (= output bits) per feature.
      mode: threshold placement, one of :data:`PLACEMENTS`.
    """

    num_features: int
    bits_per_feature: int
    mode: str = "distributive"

    @property
    def total_bits(self) -> int:
        return self.num_features * self.bits_per_feature


#: Threshold-placement modes accepted by :func:`fit_thresholds`.
PLACEMENTS = ("distributive", "uniform", "gaussian")


def _norm_ppf(q: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Returns float64 z-scores with |relative error| < 1.2e-9.
    """
    q = np.asarray(q, np.float64)
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1.0 - 0.02425
    x = np.empty_like(q)
    lo, hi = q < plow, q > phigh
    mid = ~(lo | hi)
    if lo.any():
        u = np.sqrt(-2.0 * np.log(q[lo]))
        x[lo] = ((((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
                  * u + c[5])
                 / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1.0))
    if hi.any():
        u = np.sqrt(-2.0 * np.log(1.0 - q[hi]))
        x[hi] = -((((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
                   * u + c[5])
                  / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1.0))
    if mid.any():
        u = q[mid] - 0.5
        r = u * u
        x[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
                   * r + a[5]) * u
                  / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
                     * r + 1.0))
    return x


def normalize_to_unit(x: np.ndarray, lo: np.ndarray | None = None,
                      hi: np.ndarray | None = None):
    """Affine-map features to [-1, 1). Returns (x, lo, hi)."""
    x = np.asarray(x, np.float32)
    if lo is None:
        lo = x.min(axis=0)
    if hi is None:
        hi = x.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    xn = (x - lo) / span * 2.0 - 1.0
    # right-open interval [-1, 1)
    xn = np.clip(xn, -1.0, np.nextafter(np.float32(1.0), np.float32(0.0)))
    return xn.astype(np.float32), lo, hi


def fit_thresholds(x_train: np.ndarray, spec: ThermometerSpec) -> np.ndarray:
    """Fit per-feature thresholds on (already normalized) training data.

    Args:
      x_train: (N, F) float features, normalized to [-1, 1).
      spec: encoder shape + placement mode (one of :data:`PLACEMENTS`).

    Returns float32 array of shape (F, T), ascending along T.
    """
    x = np.asarray(x_train, np.float32)
    if x.ndim != 2 or x.shape[1] != spec.num_features:
        raise ValueError(f"x_train has shape {x.shape}; expected "
                         f"(N, {spec.num_features})")
    T = spec.bits_per_feature
    qs = (np.arange(1, T + 1, dtype=np.float64)) / (T + 1)
    if spec.mode == "uniform":
        edges = np.linspace(-1.0, 1.0, T + 2, dtype=np.float32)[1:-1]
        th = np.tile(edges[None, :], (spec.num_features, 1))
    elif spec.mode == "distributive":
        th = np.quantile(x.astype(np.float64), qs, axis=0).T  # (F, T)
    elif spec.mode == "gaussian":
        mu = x.mean(axis=0, dtype=np.float64)                 # (F,)
        sd = np.maximum(x.std(axis=0, dtype=np.float64), 1e-6)
        z = _norm_ppf(qs)                                     # (T,)
        th = mu[:, None] + sd[:, None] * z[None, :]
        th = np.clip(th, -1.0,
                     np.nextafter(np.float32(1.0), np.float32(0.0)))
    else:
        raise ValueError(f"unknown thermometer mode: {spec.mode!r}; "
                         f"expected one of {PLACEMENTS}")
    return np.sort(th.astype(np.float32), axis=1)


def encode(x: torch.Tensor, thresholds: torch.Tensor, *,
           flatten: bool = True) -> torch.Tensor:
    """Thermometer-encode ``x`` (..., F) against ``thresholds`` (F, T).

    Returns float32 bits in {0, 1}: bit t of feature f is ``x_f > th[f, t]``;
    shape (..., F*T) if ``flatten`` else (..., F, T).
    """
    bits = (x[..., :, None] > thresholds).to(torch.float32)
    if flatten:
        bits = bits.reshape(*x.shape[:-1], thresholds.numel())
    return bits


def encode_packed(x: torch.Tensor, thresholds: torch.Tensor) -> PackedBits:
    """Thermometer-encode straight into packed words: bit ``f*T + t`` of
    the flattened output is ``x_f > th[f, t]``.  Bit-exact with
    :func:`encode`: ``encode_packed(x, th).unpack() == encode(x, th)``."""
    bits = x[..., :, None] > thresholds
    return PackedBits.pack(bits.reshape(*x.shape[:-1], thresholds.numel()))


# ---------------------------------------------------------------------------
# Fixed-point quantization of thresholds and inputs — the PEN path.
# ---------------------------------------------------------------------------

def quantize_fixed_point(v, frac_bits: int):
    """Quantize to signed fixed point (1, n): 1 sign bit + n fractional bits.

    Representable grid: {-1, -1+2^-n, ..., 1-2^-n}.  A tensor is quantized
    with torch, anything else with numpy; both keep float32 inputs in
    float32 and round half to even.
    """
    scale = float(2 ** frac_bits)
    if isinstance(v, torch.Tensor):
        q = torch.round(v * scale) / scale
        return torch.clamp(q, -1.0, (scale - 1.0) / scale)
    q = np.round(v * scale) / scale
    return np.clip(q, -1.0, (scale - 1.0) / scale)


__all__ = [
    "PLACEMENTS", "ThermometerSpec", "encode", "encode_packed",
    "fit_thresholds", "normalize_to_unit", "quantize_fixed_point",
]
