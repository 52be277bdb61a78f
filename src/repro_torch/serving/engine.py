"""ServingEngine: DWN classification behind a submit/drain API.

The PyTorch counterpart of the DWN half of ``repro.serving.engine``.
Batches of a spec's workload features are microbatched into power-of-two
buckets (``serving.scheduler``) and classified by a pluggable datapath
backend (``serving.backends``) on one device.  Every non-oracle backend is
checked bit-exactly against the ``apply_hard`` float oracle at startup: the
engine refuses to construct a broken datapath.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; without a
card it raises rather than fall back.

Usage:
    engine = ServingEngine("dwn-jsc-lg", max_bucket=4096)
    for xb in request_stream:
        engine.submit(xb)
    results = engine.drain()
    print(engine.report())
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..dwn import DWNArtifact, resolve_spec
from ..workloads import load_workload
from .backends import (BoundBackend, DWNModelBundle, available_backends,
                       get_backend, verify_backends)
from .scheduler import MicrobatchScheduler, Request, latency_stats


class ServingEngine:
    """DWN serving engine on one device.

    Args:
      arch: what to serve — a registered spec preset name
        (``"dwn-jsc-lg"``), a :class:`~repro_torch.dwn.DWNSpec` (the engine
        fits it on its own data split), or a
        :class:`~repro_torch.dwn.DWNArtifact` (served as-is; missing stages
        are completed in place).
      backend: datapath backend name; ``None`` takes the spec's
        ``datapath``.
      max_bucket / min_bucket: the power-of-two batch-bucket ladder.
      verify: run the startup bit-exactness check of every registered
        non-oracle backend against the float oracle.
      n_train: training rows used to fit thermometer thresholds.
      seed: data split and parameter-init seed.
      device: ``"cuda"`` (default) or ``"cpu"``.
    """

    def __init__(self, arch, *, backend: str | None = None,
                 max_bucket: int = 256, min_bucket: int = 8,
                 verify: bool = True, n_train: int = 2000, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if isinstance(arch, DWNArtifact):
            art, self.spec = arch, arch.spec
            name = arch.spec.label
        else:
            self.spec = resolve_spec(arch)
            art = DWNArtifact(self.spec)
            name = arch if isinstance(arch, str) else self.spec.label
        self.scheduler = MicrobatchScheduler(
            max_bucket=max_bucket, min_bucket=min(min_bucket, max_bucket))
        self.bit_exact: dict[str, bool] = {}
        self._drain_wall = 0.0
        self.data = load_workload(self.spec.workload, n_train,
                                  max(self.scheduler.max_bucket, 512),
                                  seed=seed)
        if art.stage == "spec":
            art.fit(self.data.x_train, seed=seed)
        if art.stage == "trained":
            art.freeze()
        art.pack(self.device)
        self.artifact = art
        self.model: DWNModelBundle = art.serving_model(name)
        self.backends = {b: BoundBackend(get_backend(b), self.model)
                         for b in available_backends()}
        backend = self.spec.datapath if backend is None else backend
        if backend not in self.backends:
            raise ValueError(f"unknown serving backend {backend!r}; "
                             f"registered: {available_backends()}")
        if verify:
            # probe at the largest bucket: the bucket serving uses most
            probe = self.data.x_test[:self.scheduler.max_bucket]
            self.bit_exact = verify_backends(
                self.model, list(self.backends.values()), probe)
        self.backend = self.backends[backend]

    @property
    def name(self) -> str:
        return self.model.arch_name

    def warmup(self, size: int | None = None) -> None:
        """Run one step of the bucket ``size``-sample requests land in
        (default: the largest), outside the request accounting — the first
        launch builds the CUDA kernels."""
        bucket = self.scheduler.max_bucket if size is None else \
            self.scheduler.bucket_for(min(size, self.scheduler.max_bucket))
        self._dwn_step(np.asarray(self.data.x_test[:bucket]))

    def _dwn_step(self, x: np.ndarray):
        """One bucket: rows to the device, one backend step, results back
        to the host (the copy back waits for the device)."""
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)
        counts, pred = self.backend(xd)
        return counts.cpu().numpy(), pred.cpu().numpy()

    def make_request(self, size: int, seed: int = 0) -> np.ndarray:
        """``size`` feature rows drawn (seeded) from the test split."""
        rng = np.random.default_rng(seed)
        sel = rng.integers(0, self.data.x_test.shape[0], size)
        return self.data.x_test[sel]

    def submit(self, payload: Any) -> Request:
        """Enqueue one (size, F) request; admission order is service
        order."""
        payload = np.asarray(payload)
        return self.scheduler.submit(payload, payload.shape[0])

    def drain(self) -> list[Request]:
        """Serve every queued request; blocks until all results are on the
        host.  Each request's ``result`` is (counts, pred)."""
        t0 = time.perf_counter()
        done = self.scheduler.drain_batched(self._dwn_step)
        self._drain_wall += time.perf_counter() - t0
        return done

    def report(self) -> dict:
        """JSON-able serving report over everything served so far.

        ``throughput_samples_per_s`` is samples per wall-clock second of
        draining; ``latency.{queue,compute,total}_ms`` are per-request
        millisecond percentiles.
        """
        reqs = list(self.scheduler.completed)
        served = sum(r.size for r in reqs)
        wall = self._drain_wall
        out = {
            "arch": self.name,
            "mode": "dwn-classify",
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "requests": len(reqs),
            "served": served,
            "throughput_samples_per_s":
                round(served / wall, 1) if wall else 0.0,
            "latency": latency_stats(reqs),
            "queue_depth": {"pending": self.scheduler.pending,
                            "max_requests": self.scheduler.max_pending},
            "datapath": self.backend.name,
            "backends": available_backends(),
            "bit_exact_vs_oracle": self.bit_exact,
            "buckets": list(self.scheduler.buckets),
            "luts": self.spec.luts,
            "bits_per_feature": self.spec.bits,
            "spec": self.spec.to_dict(),
            "spec_fingerprint": self.spec.fingerprint(),
            "artifact_stage": self.artifact.stage,
        }
        if self.model.tuned_configs:
            out["tuned_configs"] = {int(b): c.to_dict() for b, c in
                                    self.model.tuned_configs.items()}
        return out


__all__ = ["ServingEngine"]
