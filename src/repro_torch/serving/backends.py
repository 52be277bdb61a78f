"""Pluggable DWN datapath backends.

A *backend* is one implementation of the serving datapath
``features -> (class counts, argmax)`` over a frozen DWN.  All backends
share the same hardware semantics; they differ in how the bits move:

    fused-packed   one CUDA kernel launch: encode -> LUT layer(s) -> masked
                   popcount -> first argmax, every bit packed and kept in
                   shared memory (``kernels.fused``)
    packed-eager   the same packed word format as plain tensor ops
                   (``core.model.apply_hard_packed``); counterpart of the
                   reference's ``packed-xla``
    float-oracle   ``apply_hard``: every bit a float32.  The bit-exactness
                   oracle every other backend is checked against at engine
                   startup.

``BoundBackend`` binds a backend to one model and owns its per-bucket
step cache: on a CUDA device one CUDA graph per (bucket, tuned config),
captured on first use and replayed after (``kernels.graph``), the
counterpart of the reference's one ``jax.jit`` entry per bucket.
``compiles`` counts them.  ``AutoSelector`` serves each bucket on the
fastest bit-exact backend (``backend="auto"``); ``autotune_model`` tunes
the fused kernel per bucket (``kernels.autotune``); ``StepTimeEstimator``
is the continuous-batching loop's model of a step's time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.classifier import predict
from ..core.model import DWNConfig, FrozenDWN, apply_hard, apply_hard_packed
from ..core.thermometer import quantize_fixed_point
from ..kernels import autotune
from ..kernels.fused import ops as fused_ops
from ..kernels.graph import CapturedStep


@dataclasses.dataclass
class DWNModelBundle:
    """A frozen DWN plus its operands staged on ``device``.

    Every backend reads from the same bundle, so cross-backend comparisons
    compare datapaths, not weights.
    """

    name: str
    dcfg: DWNConfig
    frozen: FrozenDWN
    device: torch.device
    thresholds: torch.Tensor          # (F, T)
    mappings: list                    # per layer (m, n) int32
    tables: list                      # per layer (m, 2^n) int32
    #: bucket -> ``FusedConfig`` the fused backend serves that bucket with
    #: (absent: ``autotune.DEFAULT_CONFIG``; ``autotune_model`` fills it);
    #: read at every step, and a changed entry is captured anew.
    tuned_configs: dict = dataclasses.field(default_factory=dict)

    @property
    def num_classes(self) -> int:
        return self.dcfg.num_classes

    @property
    def arch_name(self) -> str:
        return self.name


class Backend:
    """One DWN serving datapath.  Subclass + :func:`register_backend`.

    ``make_step(model)`` returns ``fn(x) -> (counts, pred)`` for a feature
    batch ``x (B, F)`` on the model's device.  ``capturable`` says whether
    that step may be captured in a CUDA graph (it launches work on the
    current stream only, with no host sync or host-to-device copy); a
    backend that is not runs eagerly, and the engine's report says so.
    """

    name: str = "?"
    is_oracle: bool = False
    capturable: bool = True

    def make_step(self, model: DWNModelBundle) -> Callable:
        raise NotImplementedError


_REGISTRY: dict[str, Backend] = {}


def register_backend(cls):
    """Class decorator: register a Backend subclass under ``cls.name``."""
    if cls.name in _REGISTRY:
        raise ValueError(f"backend {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown serving backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


@register_backend
class FusedPackedBackend(Backend):
    """The fused CUDA kernels, bits in shared memory end to end.

    The kernel variant and samples per block come from the model's
    ``tuned_configs`` for the step's batch bucket, else from
    ``autotune.DEFAULT_CONFIG``; each config's operands are prepared once
    and reused.
    """

    name = "fused-packed"

    def make_step(self, model: DWNModelBundle) -> Callable:
        fwd_cache: dict = {}

        def fwd_for(config):
            if config not in fwd_cache:
                fwd_cache[config] = fused_ops.make_forward_packed(
                    model.thresholds, model.mappings, model.tables,
                    model.num_classes, config=config)
            return fwd_cache[config]

        # PEN models quantize inputs to the (1, n) grid before the
        # comparator bank (apply_hard semantics)
        frac = model.frozen.input_frac_bits

        def fn(x: torch.Tensor):
            fwd = fwd_for(model.tuned_configs.get(x.shape[0]))
            if frac is not None:
                x = quantize_fixed_point(x, frac)
            return fwd(x)
        return fn


@register_backend
class PackedEagerBackend(Backend):
    """Packed words through plain tensor ops (no custom kernel).  Runs
    eagerly: ``apply_hard_packed`` copies the frozen numpy arrays and the
    class masks to the device on every call, which a capture refuses."""

    name = "packed-eager"
    capturable = False

    def make_step(self, model: DWNModelBundle) -> Callable:
        frozen = model.frozen

        def fn(x: torch.Tensor):
            counts = apply_hard_packed(frozen, x)
            return counts, predict(counts)
        return fn


@register_backend
class FloatOracleBackend(Backend):
    """``apply_hard``: the float bit-exactness oracle.  Runs eagerly, for
    the reason :class:`PackedEagerBackend` does."""

    name = "float-oracle"
    is_oracle = True
    capturable = False

    def make_step(self, model: DWNModelBundle) -> Callable:
        frozen = model.frozen

        def fn(x: torch.Tensor):
            counts = apply_hard(frozen, x)
            return counts, predict(counts)
        return fn


class BoundBackend:
    """A backend bound to one model, with a per-bucket step cache.

    ``step_for(bucket)`` returns the step that serves a (bucket, F) batch
    of host or device rows.  On a CUDA device, for a ``capturable``
    backend, it is one CUDA graph per (bucket, the model's tuned config
    for the bucket): the first call warms up and captures, later calls
    copy the rows in and replay, and setting ``model.tuned_configs[b]``
    makes the next step at ``b`` capture anew.  Elsewhere the step runs
    ``make_step``'s function eagerly.  ``compiles`` maps bucket -> steps
    built there (captures on CUDA, first builds on the CPU).

    The outputs of a replayed step are the graph's own tensors, which the
    next replay of the same step overwrites: copy them out first.
    """

    def __init__(self, backend: Backend, model: DWNModelBundle):
        self.backend = backend
        self.model = model
        self._fn = backend.make_step(model)
        self._steps: dict[tuple, Callable] = {}
        self.compiles: dict[int, int] = {}

    @property
    def name(self) -> str:
        return self.backend.name

    @property
    def is_oracle(self) -> bool:
        return self.backend.is_oracle

    @property
    def graphed(self) -> bool:
        """Whether steps replay CUDA graphs (else they run eagerly)."""
        return self.model.device.type == "cuda" and self.backend.capturable

    def step_for(self, bucket: int) -> Callable:
        # an eager step reads the tuned config at every call; a graph
        # holds the one it was captured with
        key = (bucket, self.model.tuned_configs.get(bucket)) \
            if self.graphed else bucket
        if key not in self._steps:
            self.compiles[bucket] = self.compiles.get(bucket, 0) + 1
            if self.graphed:
                self._steps[key] = CapturedStep(self._fn, self.model.device)
            else:
                fn, dev = self._fn, self.model.device
                self._steps[key] = lambda x: fn(x.to(dev))
        return self._steps[key]

    def __call__(self, x: torch.Tensor):
        return self.step_for(x.shape[0])(x)


# ---------------------------------------------------------------------------
# per-bucket tuning and backend auto-select
# ---------------------------------------------------------------------------

def time_backend_step(bound: BoundBackend, x: torch.Tensor, *,
                      iters: int = 3) -> float:
    """Best-of-``iters`` seconds of one bound step at x's bucket, as a
    running server takes it (a graph replay where the backend replays
    graphs); the first, untimed call builds the step.  The loop is
    ``autotune.time_step`` with a 1 ms accumulation floor, so that
    microsecond steps are raced over enough calls."""
    return autotune.time_step(bound.step_for(x.shape[0]), x, iters=iters,
                              min_time_s=1e-3)


def autotune_model(model: DWNModelBundle, buckets, x_probe, *,
                   spec_fingerprint: str,
                   cache: autotune.AutotuneCache | None = None,
                   iters: int = 5, timer=None, force: bool = False) -> dict:
    """Fill ``model.tuned_configs`` with the fastest fused config of each
    bucket (a cache hit first, else a timed sweep,
    ``autotune.tune_fused``).  Tune before serving: a bucket's step is
    captured with the config in effect, and a later change recaptures.

    Args:
      model: the served bundle; mutated in place.
      buckets: the bucket ladder.
      x_probe: (>= max(buckets), F) probe rows; a bucket tunes on its
        leading rows.
      spec_fingerprint: ``DWNSpec.fingerprint()``, the cache identity.
      cache / iters / timer / force: passed to ``tune_fused``.

    Returns {bucket: FusedConfig} (also left on the model).
    """
    cache = cache if cache is not None else autotune.AutotuneCache()
    kwargs = {} if timer is None else {"timer": timer}
    for bucket in buckets:
        model.tuned_configs[bucket] = autotune.tune_fused(
            model.thresholds, model.mappings, model.tables,
            model.num_classes, x_probe[:bucket],
            spec_fingerprint=spec_fingerprint,
            input_frac_bits=model.frozen.input_frac_bits, cache=cache,
            iters=iters, min_time_s=1e-3, force=force, **kwargs)
    return dict(model.tuned_configs)


class AutoSelector:
    """Per-bucket chooser of the fastest bit-exact backend.

    Times every backend that passed the startup bit-exactness check (the
    oracle is exact by definition) at a bucket, as it serves (graph
    replays where it replays graphs), and serves the bucket on the
    winner.  The engine calibrates its whole bucket ladder at startup;
    :meth:`backend_for` calibrates a bucket it has not seen.  The fused
    backend is timed with the tuned config of the bucket
    (``autotune_model`` runs first); ``configs`` records it.

    Near-ties break toward ``fused-packed``: a backend displaces it only
    by beating it by more than ``tie_break_pct``.

    Attributes:
      choice: bucket -> winning backend name.
      timings: bucket -> {backend: best step seconds}.
      configs: bucket -> tuned ``FusedConfig`` in effect when the bucket
        was calibrated (None for an untuned bucket).
    """

    #: preferred backend on near-ties (the fused kernels).
    TIE_BREAK_BACKEND = "fused-packed"

    def __init__(self, backends: dict[str, BoundBackend],
                 bit_exact: dict[str, bool], *, iters: int = 5,
                 tie_break_pct: float = 10.0):
        self.backends = backends
        self.eligible = [name for name, b in backends.items()
                         if b.is_oracle or bit_exact.get(name, False)]
        if not self.eligible:
            raise ValueError("no bit-exact backend to select from")
        self.iters = iters
        self.tie_break_pct = tie_break_pct
        self.choice: dict[int, str] = {}
        self.timings: dict[int, dict[str, float]] = {}
        self.configs: dict[int, autotune.FusedConfig | None] = {}

    def calibrate(self, x: torch.Tensor) -> str:
        """Time every eligible backend at x's bucket; returns the winner."""
        bucket = x.shape[0]
        times = {name: time_backend_step(self.backends[name], x,
                                         iters=self.iters)
                 for name in self.eligible}
        self.timings[bucket] = times
        best = min(times, key=times.get)
        tb = self.TIE_BREAK_BACKEND
        if (tb in times and tb != best
                and times[tb] <= times[best]
                * (1 + self.tie_break_pct / 100)):
            best = tb
        self.choice[bucket] = best
        self.configs[bucket] = \
            self.backends[best].model.tuned_configs.get(bucket)
        return best

    def backend_for(self, x: torch.Tensor) -> BoundBackend:
        """The calibrated winner for x's bucket (calibrating it first if
        it is new)."""
        bucket = x.shape[0]
        if bucket not in self.choice:
            self.calibrate(x)
        return self.backends[self.choice[bucket]]


# ---------------------------------------------------------------------------
# per-bucket step-time estimates (admission control's model of the device)
# ---------------------------------------------------------------------------

class StepTimeEstimator:
    """Per-bucket step wall-time estimates for SLO-aware admission.

    The continuous-batching loop needs to answer "how long until this
    request could complete?" *before* serving it.  The estimate has two
    sources, in order of freshness:

    * a **seed** from startup calibration — ``AutoSelector`` already
      times every backend at every bucket for ``backend="auto"``, so the
      winning backend's time per bucket is free; pinned backends seed
      from one ``time_backend_step`` probe at ``max_bucket`` (step time
      is overhead-dominated at these model sizes, so one bucket's time
      is a usable prior for the whole ladder).  On the card both are
      graph replays fed from host rows: they leave out the copy of the
      results back and the batch's assembly on the host, so the seed is
      optimistic, as admission wants it;
    * an **online EWMA** over the actual step times the loop observes
      (``update`` after every step), which quickly overrides the seed
      and tracks drift (clocks, contention, host load).

    ``estimate`` returns seconds or None when nothing is known for the
    bucket (or any larger one — a larger bucket's time upper-bounds a
    smaller one's here, so it stands in rather than admit blindly).
    """

    def __init__(self, *, alpha: float = 0.25):
        self.alpha = alpha
        self._seed: dict[int, float] = {}
        self._ewma: dict[int, float] = {}
        self.updates = 0

    def seed(self, bucket: int, seconds: float) -> None:
        """Install a calibration prior (ignored once EWMA data exists)."""
        self._seed[int(bucket)] = float(seconds)

    def update(self, bucket: int, seconds: float) -> None:
        """Fold one observed step time into the bucket's EWMA."""
        b = int(bucket)
        prev = self._ewma.get(b)
        self._ewma[b] = (seconds if prev is None
                         else prev + self.alpha * (seconds - prev))
        self.updates += 1

    def estimate(self, bucket: int) -> float | None:
        """Best current estimate (s) for one step at ``bucket``, or None."""
        b = int(bucket)
        for table in (self._ewma, self._seed):
            if b in table:
                return table[b]
        # fall back to the nearest known larger bucket (upper bound)
        for table in (self._ewma, self._seed):
            larger = [v for k, v in table.items() if k > b]
            if larger:
                return min(larger)
        return None

    def snapshot(self) -> dict:
        """JSON-able {bucket: est_ms} view for reports."""
        buckets = sorted(set(self._seed) | set(self._ewma))
        return {int(b): round((self.estimate(b) or 0.0) * 1e3, 4)
                for b in buckets}


def estimator_from_calibration(auto: "AutoSelector") -> StepTimeEstimator:
    """Seed an estimator from an ``AutoSelector``'s startup calibration:
    each bucket's prior is the *chosen* backend's measured step time."""
    est = StepTimeEstimator()
    for bucket, times in auto.timings.items():
        choice = auto.choice.get(bucket)
        if choice in times:
            est.seed(bucket, times[choice])
    return est


# ---------------------------------------------------------------------------
# startup cross-check
# ---------------------------------------------------------------------------

def verify_backends(model: DWNModelBundle,
                    backends: Sequence[BoundBackend],
                    x_probe: np.ndarray) -> dict[str, bool]:
    """Bit-exactness gate: every non-oracle backend vs the float oracle.

    Runs each backend through its step cache (so serving reuses the
    steps) on the same probe rows and compares counts *and* predictions
    exactly: on all of ``x_probe``, and on its leading rows at every
    bucket whose tuned config (``model.tuned_configs``) differs from
    ``autotune.DEFAULT_CONFIG``.  Raises ``RuntimeError`` on any
    divergence — refusing to serve a broken datapath — and returns
    {name: True} for the checked backends otherwise.
    """
    x_all = torch.from_numpy(np.ascontiguousarray(x_probe, np.float32))
    sizes = {x_all.shape[0]} | {
        b for b, cfg in model.tuned_configs.items()
        if cfg != autotune.DEFAULT_CONFIG and b < x_all.shape[0]}
    oracle_bound = next((b for b in backends if b.is_oracle),
                        BoundBackend(get_backend("float-oracle"), model))
    results: dict[str, bool] = {}
    for size in sorted(sizes):
        x = x_all[:size]
        counts_ref, pred_ref = (t.cpu().numpy() for t in oracle_bound(x))
        for b in backends:
            if b.is_oracle:
                continue
            counts, pred = (t.cpu().numpy() for t in b(x))
            ok = (np.array_equal(counts.astype(np.float32),
                                 counts_ref.astype(np.float32))
                  and np.array_equal(pred, pred_ref))
            if not ok:
                raise RuntimeError(
                    f"serving backend {b.name!r} diverged from the "
                    f"apply_hard oracle on {model.arch_name!r} at {size} "
                    f"rows; refusing to serve a broken datapath")
            results[b.name] = True
    return results


__all__ = [
    "AutoSelector", "Backend", "BoundBackend", "DWNModelBundle",
    "StepTimeEstimator", "autotune_model", "available_backends",
    "estimator_from_calibration", "get_backend", "register_backend",
    "time_backend_step", "verify_backends",
]
