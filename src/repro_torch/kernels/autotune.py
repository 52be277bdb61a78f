"""Persistent per-(model, bucket, device) tuner of the fused DWN kernels.

The PyTorch counterpart of the reference's ``repro.kernels.autotune``.
The fused datapath has two kernel variants, ``packed`` (K2) and
``batch-major`` (K1), and a tile size, ``block_b``; which is fastest
depends on the batch bucket.  :func:`tune_fused` times the candidates on
probe rows and keeps the winner in a JSON cache keyed by the served spec's
fingerprint, the bucket, the device kind and a fingerprint of the kernel
sources, so that editing the kernels invalidates stale entries instead of
serving them.

Cache location: ``$REPRO_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune/fused_configs.json`` (the reference keeps
its own file under ``~/.cache/repro/``; the two never share entries).  An
absent or corrupt file is a miss, never an error.  Writes replace the
file atomically.

Two things differ from the reference by design:

* **Candidates.** Here ``block_b`` is samples per CUDA block, rounded up
  to a multiple of 32 and cut to shared memory (:class:`FusedConfig`), so
  the reference's {bucket, bucket/2} rows do not translate.  Every
  bucket's candidates hold both variants at ``block_b`` 32 and, where the
  bucket has more than 32 rows, 64: 32 was the fastest of {32, ..., 256}
  for both kernels at 4096 rows of dwn-jsc-lg and 64 the second (PERF.md).
* **No hidden failure.** Only a candidate that the wrapper refuses before
  any launch (a ``ValueError`` of its operand checks, on a malformed
  operand) is skipped, and the cache entry
  records it as ``"refused"``.  Any other error, a CUDA error above all,
  propagates; and if every candidate is refused :func:`tune_fused`
  raises, since :data:`DEFAULT_CONFIG` would be refused too.  The
  reference skips any failing candidate and falls back to its default,
  which would hide a broken kernel on the card.

On CUDA each candidate is timed as the engine serves it: as a replay of
its CUDA graph (``kernels.graph.CapturedStep``).  Timed as eager calls,
the race would measure the wrapper's host time (0.07-0.09 ms a call on an
H100), not the 0.008-0.029 ms kernels.  The timing loop takes an
injectable ``timer``, so the tuner is deterministic under a stubbed clock.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path

import torch

#: kernel variants (see ``fused/ops.py``).
VARIANTS = ("packed", "batch-major")
#: ``block_b`` values every bucket's candidates are drawn from.
CANDIDATE_BLOCK_B = (32, 64)
#: what a refused candidate records in a cache entry's timings.
REFUSED = "refused"


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """One point in the fused-kernel configuration space.

    Attributes:
      variant: "packed" (the full F*T bit tensor in words) or
        "batch-major" (direct-wire first layer).
      block_b: samples one CUDA block of the packed kernels takes at a
        time (a tile), rounded up to a multiple of 32 (a warp's lanes are
        32 samples) and down to what fits a block's shared memory beside
        the model.  The results do not depend on it.  The default, one
        warp's 32 samples, was the fastest of {32, 64, 128, 256} for both
        kernels at dwn-jsc-lg width and 4096 rows on an H100 80GB HBM3 at
        700 W (``chip_smoke.py``; PERF.md).
      block_m: the most LUTs a CUDA block of the float fused kernel
        (``fused_dwn``) stages at once, its slice of the layer (the
        reference's tile of its sequential m axis), cut to whole 32-LUT
        chunks and class groups (``kernel.plan_fused_dwn``).  No other
        kernel reads it; the results do not depend on it.
    """

    variant: str = "packed"
    block_b: int = 32
    block_m: int = 128

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown fused variant {self.variant!r}; "
                             f"choose one of {VARIANTS}")
        if self.block_b < 1:
            raise ValueError(f"block_b must be >= 1, got {self.block_b}")
        if self.block_m < 1:
            raise ValueError(f"block_m must be >= 1, got {self.block_m}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FusedConfig":
        """Inverse of :meth:`to_dict`; keys it does not know are ignored,
        missing ones take their defaults (as the reference's)."""
        return cls(**{k: d[k] for k in ("variant", "block_b", "block_m")
                      if k in d})

    @property
    def label(self) -> str:
        return f"{self.variant}/b{self.block_b}"


#: what an untuned model serves with.
DEFAULT_CONFIG = FusedConfig()


# ---------------------------------------------------------------------------
# fingerprints and keys
# ---------------------------------------------------------------------------

@functools.cache
def kernel_fingerprint() -> str:
    """Hash of the sources whose edits change the fused kernels' speed:
    ``fused/csrc/fused_dwn.cu``, the device code it includes
    (``csrc/tiles.cuh``), ``fused/{kernel,ops}.py`` and
    ``core/bitpack.py``.  Tuned entries carry it, so a kernel edit
    invalidates them."""
    here = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for path in (here / "fused" / "csrc" / "fused_dwn.cu",
                 here / "csrc" / "tiles.cuh",
                 here / "fused" / "kernel.py", here / "fused" / "ops.py",
                 here.parent / "core" / "bitpack.py"):
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def device_kind(device) -> str:
    """What the timings are valid on: the card's name for a CUDA device
    (``torch.cuda.get_device_name``), ``"cpu"`` for the CPU (where the
    wrappers run their plain versions)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def cache_key(spec_fingerprint: str, bucket: int, device: str) -> str:
    """``device`` is a :func:`device_kind`."""
    return f"{spec_fingerprint}:{bucket}:{device}"


def default_cache_path() -> Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return Path(env)
    return (Path.home() / ".cache" / "repro_torch" / "autotune" /
            "fused_configs.json")


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

class AutotuneCache:
    """JSON-file cache of the winning :class:`FusedConfig` per key::

        {"entries": {"<spec_fp>:<bucket>:<device kind>": {
            "code": "<kernel_fingerprint() at tune time>",
            "config": {"variant": ..., "block_b": ..., "block_m": ...},
            "timings_us": {"packed/b32": 28.4, "batch-major/b64": "refused",
                           ...}}}}

    :meth:`get` misses (returns None) when the file is absent or corrupt,
    the key is absent, or the stored ``code`` is not the current
    :func:`kernel_fingerprint`.
    """

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self._entries: dict | None = None

    def _load(self) -> dict:
        if self._entries is None:
            try:
                data = json.loads(self.path.read_text())
                self._entries = dict(data["entries"])
            except (OSError, ValueError, KeyError, TypeError):
                self._entries = {}
        return self._entries

    def get(self, spec_fingerprint: str, bucket: int,
            device: str) -> FusedConfig | None:
        entry = self._load().get(cache_key(spec_fingerprint, bucket, device))
        if not isinstance(entry, dict) or \
                entry.get("code") != kernel_fingerprint():
            return None
        try:
            return FusedConfig.from_dict(entry["config"])
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, spec_fingerprint: str, bucket: int, config: FusedConfig,
            device: str, timings_us: dict | None = None) -> None:
        """Record ``config`` (and each candidate's microseconds, or
        :data:`REFUSED`) and rewrite the file atomically."""
        entries = self._load()
        entries[cache_key(spec_fingerprint, bucket, device)] = {
            "code": kernel_fingerprint(),
            "config": config.to_dict(),
            "timings_us": {k: v if v == REFUSED else round(v, 3)
                           for k, v in (timings_us or {}).items()},
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"entries": entries}, fh, indent=1,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise


# ---------------------------------------------------------------------------
# timing + tuning
# ---------------------------------------------------------------------------

def _wait(out) -> None:
    """Wait for the device that holds ``out``'s tensors (the counterpart
    of the reference's ``block_until_ready``)."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def time_step(fn, x, *, iters: int = 3, timer=time.perf_counter,
              min_time_s: float = 0.0, max_iters: int = 50) -> float:
    """Best-of-``iters`` seconds of ``fn(x)``, each call waited for on the
    device, after one untimed warmup call.

    ``min_time_s > 0`` keeps sampling past ``iters`` (up to ``max_iters``)
    until that much measured time has accumulated, so that microsecond
    steps are raced over tens of calls.
    """
    _wait(fn(x))
    best, total, n = float("inf"), 0.0, 0
    while n < max(1, iters) or (total < min_time_s and n < max_iters):
        t0 = timer()
        _wait(fn(x))
        dt = timer() - t0
        best = min(best, dt)
        total += dt
        n += 1
    return best


def candidate_configs(bucket: int) -> list[FusedConfig]:
    """Both variants at each ``block_b`` of :data:`CANDIDATE_BLOCK_B` that
    gives the bucket a tile layout of its own (a bucket of at most 32 rows
    has one tile whatever ``block_b`` asks for)."""
    rows = [b for b in CANDIDATE_BLOCK_B
            if b == CANDIDATE_BLOCK_B[0] or b < bucket + 32]
    return [FusedConfig(variant=v, block_b=r) for v in VARIANTS
            for r in rows]


def tune_fused(thresholds: torch.Tensor, mappings, tables, num_classes: int,
               x_probe, *, spec_fingerprint: str,
               input_frac_bits: int | None = None,
               cache: AutotuneCache | None = None,
               candidates: list[FusedConfig] | None = None,
               iters: int = 2, timer=time.perf_counter,
               min_time_s: float = 0.0, force: bool = False) -> FusedConfig:
    """Pick (and persist) the fastest fused config for one bucket.

    Args:
      thresholds / mappings / tables / num_classes: the model's operands
        as ``serving.backends.DWNModelBundle`` stages them; the timings
        are taken on their device.
      x_probe: (bucket, F) probe rows; the bucket is their count.
      spec_fingerprint: ``DWNSpec.fingerprint()`` of the served model.
      input_frac_bits: PEN input quantization (None for TEN), applied
        before the kernel as the serving backend does.
      cache: config cache (None: :func:`default_cache_path`); a hit skips
        timing.
      candidates: the sweep (default :func:`candidate_configs`).
      iters / timer / min_time_s: timing knobs (see :func:`time_step`).
      force: re-tune on a cache hit.

    Returns the winning config.  A candidate the wrapper refuses before
    any launch (``ValueError``) is skipped and recorded as refused; any
    other error propagates.  Raises ``ValueError`` if every candidate is
    refused.  On CUDA each candidate is timed as a CUDA-graph replay.
    """
    from ..core.thermometer import quantize_fixed_point
    from .fused import ops as fused_ops
    from .graph import CapturedStep

    bucket = int(x_probe.shape[0])
    device = thresholds.device
    kind = device_kind(device)
    cache = cache if cache is not None else AutotuneCache()
    if not force:
        hit = cache.get(spec_fingerprint, bucket, kind)
        if hit is not None:
            return hit
    cands = candidates if candidates is not None \
        else candidate_configs(bucket)
    x = torch.as_tensor(x_probe, dtype=torch.float32).to(device)
    if input_frac_bits is not None:
        x = quantize_fixed_point(x, input_frac_bits)
    timings: dict[str, float | str] = {}
    best_cfg, best_t = None, float("inf")
    for cfg in cands:
        try:
            fwd = fused_ops.make_forward_packed(
                thresholds, mappings, tables, num_classes, config=cfg)
            fwd(x)
        except ValueError:
            # the operand checks run before any launch
            timings[cfg.label] = REFUSED
            continue
        step = CapturedStep(fwd, device) if device.type == "cuda" else fwd
        t = time_step(step, x, iters=iters, timer=timer,
                      min_time_s=min_time_s)
        timings[cfg.label] = t * 1e6
        if t < best_t:
            best_cfg, best_t = cfg, t
    if best_cfg is None:
        raise ValueError(
            f"every fused candidate was refused at bucket {bucket}: "
            f"{[c.label for c in cands]}")
    cache.put(spec_fingerprint, bucket, best_cfg, kind, timings)
    return best_cfg


__all__ = [
    "AutotuneCache", "CANDIDATE_BLOCK_B", "DEFAULT_CONFIG", "FusedConfig",
    "REFUSED", "VARIANTS", "cache_key", "candidate_configs",
    "default_cache_path", "device_kind", "kernel_fingerprint", "time_step",
    "tune_fused",
]
