"""Config-hash keyed result cache: grid re-runs are incremental.

Every (point, settings) pair hashes to a stable key; a completed point's
:class:`~repro_torch.sweep.results.PointResult` is stored as one JSON file under
the cache root.  Re-running a grid recomputes only the points whose key is
missing — extend a grid by one axis value and only the new column runs.

The key covers everything that changes the numbers: the grid point, the
full settings (timing knobs deliberately included — a cached throughput
measured at a different batch is not the same measurement), and a
fingerprint of the number-determining source modules (cost model, core
semantics, the pipeline itself), so editing e.g. a constant in
``hw/cost.py`` invalidates old entries instead of silently serving them.

The port's copy of the reference's ``repro.sweep.cache``.  Its fingerprint
hashes the port's modules, and its settings carry the device, so the two
packages (and a CPU and a card run) never serve each other's entries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import uuid
from pathlib import Path


def _code_fingerprint() -> str:
    """Hash of the source files whose edits change sweep numbers.

    Includes the trainer stack (core/training, core/lut_layer, optim/adam,
    and the scan engine + batch trainer) and the ``repro_torch.dwn`` lifecycle
    package (spec + artifact): cached results were produced by those
    semantics, so editing them must invalidate, not silently serve, old
    entries.
    """
    from ..core import model as m1
    from ..core import thermometer as m2
    from ..hw import cost as m3
    from . import pipeline as m4
    from ..core import training as m5
    from ..core import lut_layer as m6
    from ..optim import adam as m7
    from ..training import engine as m8
    from ..training import batch as m9
    from ..dwn import spec as m10
    from ..dwn import artifact as m11
    h = hashlib.sha256()
    for mod in (m1, m2, m3, m4, m5, m6, m7, m8, m9, m10, m11):
        try:
            with open(mod.__file__, "rb") as fh:
                h.update(fh.read())
        except OSError:
            h.update(mod.__name__.encode())    # no source (frozen): name only
    return h.hexdigest()[:16]


_FINGERPRINT: str | None = None


def config_hash(payload: dict) -> str:
    """Stable short hash of a JSON-able payload (sorted-key canonical form).

    Returns the first 16 hex chars of the sha256 — enough to never collide
    over any realistic grid, short enough for filenames.
    """
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def point_key(point, settings) -> str:
    """Cache key for one (SweepPoint, SweepSettings) pair — also keyed by
    the point's resolved :class:`~repro_torch.dwn.spec.DWNSpec` (the typed
    identity every artifact is built from) and the code fingerprint
    (computed once per process)."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        _FINGERPRINT = _code_fingerprint()
    from ..dwn.spec import DWNSpec
    spec = DWNSpec.from_point(point, datapath=settings.serve_backend)
    return config_hash({"point": point.to_dict(),
                        "settings": dataclasses.asdict(settings),
                        "spec": spec.to_dict(),
                        "code": _FINGERPRINT})


class SweepCache:
    """Filesystem cache of completed sweep points.

    Crash/concurrency contract (what the resilient executor relies on):

    * ``put`` is **atomic**: the entry is serialized to a uniquely-named
      temp file in the cache root, fsync'd, and published with
      ``os.replace`` — a reader never observes a half-written entry, and
      a writer killed mid-``put`` leaves only an orphan ``*.tmp`` (swept
      by the next ``put``), never a corrupt key.  Unique temp names make
      concurrent writers (parallel sweep workers, possibly of the *same*
      key after a straggler re-dispatch) last-writer-wins safe.
    * ``get`` treats a corrupt or non-dict entry as a **miss** — the
      point recomputes; the bad file is unlinked so it cannot shadow the
      recomputed result.

    ``stats`` counts hits / misses / corrupt entries for the run, which
    is how the chaos-resume CI smoke asserts "zero recomputed points".

    Args:
      root: cache directory (created on first ``put``); None disables
        caching entirely (``get`` always misses, ``put`` is a no-op).
    """

    def __init__(self, root: str | Path | None):
        self.root = Path(root) if root else None
        self.stats = {"hits": 0, "misses": 0, "corrupt": 0}

    def _path(self, key: str) -> Path:
        assert self.root is not None
        return self.root / f"{key}.json"

    def get(self, key: str) -> dict | None:
        """Return the cached result dict for ``key``, or None on miss.

        A corrupt cache file (e.g. a non-atomic writer killed mid-write,
        or disk damage) reads as a miss, never an error — the entry is
        unlinked and the point just recomputes.
        """
        if self.root is None:
            return None
        p = self._path(key)
        try:
            with open(p) as fh:
                out = json.load(fh)
            if not isinstance(out, dict):
                raise json.JSONDecodeError("not an object", "", 0)
        except FileNotFoundError:
            self.stats["misses"] += 1
            return None
        except (json.JSONDecodeError, OSError):
            self.stats["corrupt"] += 1
            self.stats["misses"] += 1
            p.unlink(missing_ok=True)
            return None
        self.stats["hits"] += 1
        return out

    def put(self, key: str, result: dict) -> None:
        """Store a result dict under ``key`` (atomic, concurrent-safe)."""
        if self.root is None:
            return
        self.root.mkdir(parents=True, exist_ok=True)
        self._sweep_orphans()
        tmp = self.root / f".{key}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(result, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._path(key))
        finally:
            tmp.unlink(missing_ok=True)

    def _sweep_orphans(self) -> None:
        """Delete temp files abandoned by killed writers (best-effort;
        a *live* concurrent writer's temp is at most re-created)."""
        for orphan in self.root.glob(".*.tmp"):
            try:
                if orphan.stat().st_mtime < _now() - 3600:
                    orphan.unlink(missing_ok=True)
            except OSError:
                pass


def _now() -> float:
    import time
    return time.time()


__all__ = ["SweepCache", "config_hash", "point_key"]
