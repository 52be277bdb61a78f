"""ServingEngine: one submit/drain API over both served families.

The PyTorch counterpart of the reference's ``repro.serving.engine``.

DWN specs serve batched classification of their workload's features,
microbatched into power-of-two buckets (``serving.scheduler``) and
classified by a pluggable datapath backend (``serving.backends``) on one
device.  Every non-oracle backend is checked bit-exactly against the
``apply_hard`` float oracle at startup: the engine refuses to construct a
broken datapath.

LM archs (``configs.registry``; the port serves the dense ``qwen3-8b``)
serve prefill and greedy token-by-token decode against a KV cache, one
request per step, through the same queue and latency accounting.  With
``attn_impl="pallas"`` prefill attention runs the flash-attention kernel.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; without a
card it raises rather than fall back.

Usage:
    engine = ServingEngine("dwn-jsc-lg", max_bucket=4096)
    for xb in request_stream:
        engine.submit(xb)
    results = engine.drain()
    print(engine.report())

    lm = ServingEngine(dataclasses.replace(get_arch("qwen3-8b"),
                                           attn_impl="pallas"),
                       prompt_len=2048, gen=16)
    lm.submit(lm.make_request(4))
    tokens = lm.drain()[0].result["tokens"]         # (4, 16)
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..configs import ArchConfig, get_arch, list_archs
from ..configs.registry import NOT_PORTED
from ..device import resolve_device
from ..dwn import DWNArtifact, resolve_spec
from ..models import api
from ..workloads import load_workload
from .backends import (BoundBackend, DWNModelBundle, available_backends,
                       get_backend, verify_backends)
from .scheduler import MicrobatchScheduler, Request, latency_stats


def _lm_config(arch) -> ArchConfig | None:
    """The LM config ``arch`` names or is, or None for a DWN target."""
    if isinstance(arch, ArchConfig):
        if arch.family == "dwn":
            raise ValueError(f"{arch.name}: the port serves DWN models by "
                             f"spec preset name, DWNSpec or DWNArtifact")
        return arch
    if isinstance(arch, str) and (arch in list_archs()
                                  or arch in NOT_PORTED):
        return get_arch(arch)
    return None


class ServingEngine:
    """Serving engine on one device; the family is chosen at construction.

    Args:
      arch: what to serve — an LM arch name (``"qwen3-8b"``) or
        ``ArchConfig``; or a DWN spec preset name (``"dwn-jsc-lg"``), a
        :class:`~repro_torch.dwn.DWNSpec` (the engine fits it on its own
        data split), or a :class:`~repro_torch.dwn.DWNArtifact` (served
        as-is; missing stages are completed in place).
      backend: DWN datapath backend name; ``None`` takes the spec's
        ``datapath``.
      max_bucket / min_bucket: DWN: the power-of-two batch-bucket ladder.
      verify: DWN: run the startup bit-exactness check of every registered
        non-oracle backend against the float oracle.
      n_train: DWN: training rows used to fit thermometer thresholds.
      seed: data split (DWN) and parameter-init seed.
      device: ``"cuda"`` (default) or ``"cpu"``.
      reduced: LM: serve the tiny same-family variant (``cfg.reduced()``).
      prompt_len / gen: LM: prompt tokens per sequence and tokens generated
        per request.
      model_parallel: LM: must be 1 — the port serves on one card.
    """

    def __init__(self, arch, *, backend: str | None = None,
                 max_bucket: int = 256, min_bucket: int = 8,
                 verify: bool = True, n_train: int = 2000, seed: int = 0,
                 device=None, reduced: bool = False, prompt_len: int = 32,
                 gen: int = 16, model_parallel: int = 1):
        self.device = resolve_device(device)
        self.seed = seed
        self.scheduler = MicrobatchScheduler(
            max_bucket=max_bucket, min_bucket=min(min_bucket, max_bucket))
        self._drain_wall = 0.0
        cfg = _lm_config(arch)
        self.family = "dwn" if cfg is None else "lm"
        if cfg is None:
            self._init_dwn(arch, backend, verify, n_train)
        else:
            self._init_lm(cfg.reduced() if reduced else cfg, prompt_len,
                          gen, model_parallel)

    # ------------------------------------------------------------------
    # DWN classification path
    # ------------------------------------------------------------------

    def _init_dwn(self, arch, backend: str | None, verify: bool,
                  n_train: int) -> None:
        if isinstance(arch, DWNArtifact):
            art, self.spec = arch, arch.spec
            name = arch.spec.label
        else:
            self.spec = resolve_spec(arch)
            art = DWNArtifact(self.spec)
            name = arch if isinstance(arch, str) else self.spec.label
        self.bit_exact: dict[str, bool] = {}
        self.data = load_workload(self.spec.workload, n_train,
                                  max(self.scheduler.max_bucket, 512),
                                  seed=self.seed)
        if art.stage == "spec":
            art.fit(self.data.x_train, seed=self.seed)
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
        return self.cfg.name if self.family == "lm" else self.model.arch_name

    def warmup(self, size: int | None = None) -> None:
        """Run one step outside the request accounting — the first launch
        builds the CUDA kernels.  DWN: the bucket ``size``-sample requests
        land in (default: the largest); LM: one request of ``size``
        sequences (default 1)."""
        if self.family == "lm":
            self._lm_step(self.make_request(size or 1, seed=self.seed))
            return
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

    # ------------------------------------------------------------------
    # LM prefill/decode path
    # ------------------------------------------------------------------

    def _init_lm(self, cfg: ArchConfig, prompt_len: int, gen: int,
                 model_parallel: int) -> None:
        if model_parallel != 1:
            raise NotImplementedError(
                f"model_parallel={model_parallel}: the port serves on one "
                f"card (multi-card serving is ROADMAP Queue 1 item 9)")
        self.cfg = cfg
        self.prompt_len, self.gen = prompt_len, gen
        self._lm_stats: list[tuple[float, float]] = []
        self._prefill = api.make_prefill(cfg, cache_len=prompt_len + gen)
        self._decode = api.make_decode_step(cfg)
        self.params = api.module_for(cfg).init_params(
            cfg, seed=self.seed, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lm_step(self, batch: dict) -> dict:
        """Prefill, then ``gen`` greedy decode steps -> {"tokens" (B, gen)
        int32, "prefill_s", "decode_s_per_tok"}; each time ends with the
        device idle."""
        vocab = self.cfg.vocab_size
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, batch)
        self._sync()
        t_prefill = time.perf_counter() - t0
        generated = []
        nxt = logits[:, :vocab].argmax(-1)[:, None]
        t0 = time.perf_counter()
        for _ in range(self.gen):
            generated.append(nxt)
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": nxt})
            nxt = logits[:, :vocab].argmax(-1)[:, None]
        self._sync()
        t_decode = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{self.cfg.name}: non-finite logits")
        tokens = torch.cat(generated, 1).to(torch.int32)
        return {"tokens": tokens.cpu().numpy(),
                "prefill_s": t_prefill,
                "decode_s_per_tok": t_decode / max(self.gen, 1)}

    # ------------------------------------------------------------------
    # unified submit / drain API
    # ------------------------------------------------------------------

    def make_request(self, size: int, seed: int = 0):
        """One request payload, drawn with ``numpy.random.default_rng
        (seed)``: DWN, ``size`` feature rows of the test split; LM, a batch
        ``{"tokens": (size, prompt_len) int32}`` of uniform token ids (the
        reference draws them with ``jax.random``, which torch cannot
        reproduce)."""
        rng = np.random.default_rng(seed)
        if self.family == "lm":
            return {"tokens": rng.integers(
                0, self.cfg.vocab_size,
                (size, self.prompt_len)).astype(np.int32)}
        sel = rng.integers(0, self.data.x_test.shape[0], size)
        return self.data.x_test[sel]

    def submit(self, payload: Any) -> Request:
        """Enqueue one request: a (size, F) feature array (DWN) or an LM
        batch dict with a (size, prompt_len) ``tokens`` entry.  Admission
        order is service order."""
        if self.family == "lm":
            size = int(np.asarray(payload["tokens"]).shape[0])
            return self.scheduler.submit(payload, size)
        payload = np.asarray(payload)
        return self.scheduler.submit(payload, payload.shape[0])

    def drain(self) -> list[Request]:
        """Serve every queued request; blocks until all results are on the
        host.  A DWN request's ``result`` is (counts, pred); an LM
        request's is the dict of :meth:`_lm_step`."""
        t0 = time.perf_counter()
        if self.family == "lm":
            done = self.scheduler.drain_serial(self._lm_step)
            self._lm_stats.extend((r.result["prefill_s"],
                                   r.result["decode_s_per_tok"])
                                  for r in done)
        else:
            done = self.scheduler.drain_batched(self._dwn_step)
        self._drain_wall += time.perf_counter() - t0
        return done

    def report(self) -> dict:
        """JSON-able serving report over everything served so far.

        ``throughput_samples_per_s`` is samples (DWN) or sequences (LM) per
        wall-clock second of draining; ``latency.{queue,compute,total}_ms``
        are per-request millisecond percentiles; LM ``prefill_s`` and
        ``decode_s_per_tok`` are seconds.
        """
        reqs = list(self.scheduler.completed)
        served = sum(r.size for r in reqs)
        wall = self._drain_wall
        out = {
            "arch": self.name,
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
        }
        if self.family == "lm":
            out.update({
                "family": self.cfg.family,
                "mode": "lm-generate",
                "prompt_len": self.prompt_len,
                "generated": self.gen,
                "model_parallel": 1,
                "attn_impl": self.cfg.attn_impl,
            })
            if self._lm_stats:
                out["prefill_s"] = round(
                    float(np.mean([s[0] for s in self._lm_stats])), 3)
                out["decode_s_per_tok"] = round(
                    float(np.mean([s[1] for s in self._lm_stats])), 4)
            return out
        out.update({
            "mode": "dwn-classify",
            "datapath": self.backend.name,
            "backends": available_backends(),
            "bit_exact_vs_oracle": self.bit_exact,
            "buckets": list(self.scheduler.buckets),
            "luts": self.spec.luts,
            "bits_per_feature": self.spec.bits,
            "spec": self.spec.to_dict(),
            "spec_fingerprint": self.spec.fingerprint(),
            "artifact_stage": self.artifact.stage,
        })
        if self.model.tuned_configs:
            out["tuned_configs"] = {int(b): c.to_dict() for b, c in
                                    self.model.tuned_configs.items()}
        return out


__all__ = ["ServingEngine"]
