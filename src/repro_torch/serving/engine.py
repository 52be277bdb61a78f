"""ServingEngine: one submit/drain API over both served families.

The PyTorch counterpart of the reference's ``repro.serving.engine``.

DWN specs serve batched classification of their workload's features,
microbatched into power-of-two buckets (``serving.scheduler``) and
classified by a pluggable datapath backend (``serving.backends``) on one
device.  On a CUDA card each (backend, bucket) step is one CUDA graph,
captured once and replayed.  Every non-oracle backend is checked
bit-exactly against the ``apply_hard`` float oracle at startup: the
engine refuses to construct a broken datapath.  ``backend="auto"`` tunes
the fused kernel per bucket (``kernels.autotune``) and serves each bucket
on the fastest bit-exact backend (``backends.AutoSelector``).

LM archs (``configs.registry``; the port serves the dense ``qwen3-8b``)
serve prefill and greedy token-by-token decode against a KV cache, one
request per step, through the same queue and latency accounting.  With
``attn_impl="pallas"`` prefill attention runs the flash-attention kernel.
With ``dwn_head=`` an LM engine also serves a packed DWN classification
head on its own backbone's pooled features (``classify`` requests,
``workloads.lm_head.pool_features``): one engine, both request kinds.
The head's counts go through its spec's serving backend (``fused-packed``:
K2, a CUDA graph replay per request size on the card), checked at startup
against the ``apply_hard`` oracle on this backbone's features.

DWN engines have two serving modes over the same datapath and step cache:

* **sync facade** (``submit`` + ``drain``): closed-loop, admission-order
  microbatching;
* **continuous batching** (``serve()`` / ``submit_async``): a scheduler
  thread keeps steps in flight while requests stream in, results complete
  out of order through per-request futures, deadlines are enforced by
  SLO-aware admission control, and a bounded queue exerts backpressure
  (``serving.continuous``).  Before the thread starts, every bucket of
  the ladder has its step built (on the card, its CUDA graph captured):
  a capture while another thread launches work on the card would fail,
  so no capture happens during a session.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; without a
card it raises rather than fall back.

Usage:
    engine = ServingEngine("dwn-jsc-lg", max_bucket=4096, backend="auto")
    # or a trained artifact, as either package saved it:
    # ServingEngine(DWNArtifact.load("ckpt/"), backend="auto")
    for xb in request_stream:
        engine.submit(xb)
    results = engine.drain()
    print(engine.report())

    lm = ServingEngine(dataclasses.replace(get_arch("qwen3-8b"),
                                           attn_impl="pallas"),
                       prompt_len=2048, gen=16)
    lm.submit(lm.make_request(4))
    tokens = lm.drain()[0].result["tokens"]         # (4, 16)

    head = ServingEngine("qwen3-8b", reduced=True, dwn_head="dwn-lm-head")
    head.submit(head.make_request(4))                       # LM
    head.submit(head.make_request(8, seed=1, classify=True))  # the head
    lm_req, cls_req = head.drain()      # cls_req.result: counts, pred,
                                        # features

Usage (continuous):
    with engine.serve(slo=SLOConfig(max_queue_samples=16 * 4096)):
        futs = [engine.submit_async(xb, deadline_ms=5).future
                for xb in request_stream]
        results = [f.result() for f in futs]   # ServeResult: ok or shed
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..configs import ArchConfig, get_arch, list_archs
from ..configs.registry import NOT_PORTED
from ..core.model import apply_hard
from ..device import resolve_device
from ..dwn import DWNArtifact, resolve_spec, serving_datapath
from ..models import api
from ..runtime.straggler import StragglerMonitor
from ..workloads import load_workload
from .backends import (AutoSelector, BoundBackend, DWNModelBundle,
                       StepTimeEstimator, autotune_model, available_backends,
                       estimator_from_calibration, get_backend,
                       time_backend_step, verify_backends)
from .continuous import AsyncRequest, ContinuousScheduler, SLOConfig
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
        ``datapath`` (``"packed-xla"``, the reference's name, serves on
        ``packed-eager``).  ``"auto"`` calibrates every bit-exact backend
        at every bucket of the ladder at startup and serves each bucket on
        the fastest (``backends.AutoSelector``).
      max_bucket / min_bucket: DWN: the power-of-two batch-bucket ladder.
      verify: DWN: run the startup bit-exactness check of every registered
        non-oracle backend against the float oracle (``"auto"`` always
        runs it).
      autotune: DWN: tune the fused kernel's variant and ``block_b`` per
        bucket at startup (``backends.autotune_model``; a hit in the
        persistent cache skips the timing).  ``None`` resolves to True
        exactly when ``backend == "auto"``; ``REPRO_AUTOTUNE=0`` turns it
        off.
      n_train: DWN: training rows used to fit thermometer thresholds.
      seed: data split (DWN) and parameter-init seed.
      device: ``"cuda"`` (default) or ``"cpu"``.
      reduced: LM: serve the tiny same-family variant (``cfg.reduced()``).
      prompt_len / gen: LM: prompt tokens per sequence and tokens generated
        per request.
      model_parallel: LM: must be 1 — the port serves on one card.
      dwn_head: LM only — a packed DWN classification head on the
        backbone's pooled features: a ``DWNArtifact``, a checkpoint path
        or a spec preset name such as ``"dwn-lm-head"`` (fitted on 512
        rows of its workload, untrained, as the reference does).
        ``classify`` requests then serve through the same queue; with
        ``verify`` its counts are checked against ``apply_hard`` at
        startup (``head_bit_exact``).
    """

    def __init__(self, arch, *, backend: str | None = None,
                 max_bucket: int = 256, min_bucket: int = 8,
                 verify: bool = True, autotune: bool | None = None,
                 n_train: int = 2000, seed: int = 0,
                 device=None, reduced: bool = False, prompt_len: int = 32,
                 gen: int = 16, model_parallel: int = 1, dwn_head=None):
        self.device = resolve_device(device)
        self.seed = seed
        self.scheduler = MicrobatchScheduler(
            max_bucket=max_bucket, min_bucket=min(min_bucket, max_bucket))
        self._drain_wall = 0.0
        #: anomalous step times surface as counters in report(); fed by
        #: both the sync drain loop and the continuous-batching loop
        self.straggler = StragglerMonitor()
        self._cont: ContinuousScheduler | None = None
        self.estimator: StepTimeEstimator | None = None
        #: slim async requests from finished serve() sessions + the last
        #: session's loop counters (report() merges the live session in)
        self._async_done: list[AsyncRequest] = []
        self._async_counters: dict = {}
        self.head_artifact: DWNArtifact | None = None
        self.head_bit_exact: bool | None = None
        self._head_served = 0
        cfg = _lm_config(arch)
        self.family = "dwn" if cfg is None else "lm"
        if cfg is None:
            if dwn_head is not None:
                raise ValueError(
                    "dwn_head attaches to an LM engine (the head rides the "
                    "backbone); DWN archs already serve classification")
            self._init_dwn(arch, backend, verify, autotune, n_train)
        else:
            self._init_lm(cfg.reduced() if reduced else cfg, prompt_len,
                          gen, model_parallel)
            if dwn_head is not None:
                self._init_dwn_head(dwn_head, verify)

    # ------------------------------------------------------------------
    # DWN classification path
    # ------------------------------------------------------------------

    def _init_dwn(self, arch, backend: str | None, verify: bool,
                  autotune: bool | None, n_train: int) -> None:
        if isinstance(arch, DWNArtifact):
            art, self.spec = arch, arch.spec
            name = arch.spec.label
        else:
            self.spec = resolve_spec(arch)
            art = DWNArtifact(self.spec)
            name = arch if isinstance(arch, str) else self.spec.label
        self.bit_exact: dict[str, bool] = {}
        self.tuned_configs: dict = {}
        self.data = load_workload(self.spec.workload, n_train,
                                  max(self.scheduler.max_bucket, 512),
                                  seed=self.seed, device=self.device)
        if art.stage == "spec":
            art.fit(self.data.x_train, seed=self.seed)
        if art.stage == "trained":
            art.freeze()
        art.pack(self.device)
        self.artifact = art
        self.model: DWNModelBundle = art.serving_model(name)
        self.backends = {b: BoundBackend(get_backend(b), self.model)
                         for b in available_backends()}
        backend = serving_datapath(
            self.spec.datapath if backend is None else backend)
        if backend != "auto" and backend not in self.backends:
            raise ValueError(f"unknown serving backend {backend!r}; "
                             f"registered: {available_backends()}")
        probe = self.data.x_test[:self.scheduler.max_bucket]
        if autotune is None:
            autotune = backend == "auto"
        if os.environ.get("REPRO_AUTOTUNE") == "0":
            autotune = False
        if autotune:
            # before any step is captured, so that the verification
            # below checks the tuned kernels
            self.tuned_configs = autotune_model(
                self.model, self.scheduler.buckets, probe,
                spec_fingerprint=self.spec.fingerprint())
        if verify or backend == "auto":
            # probes the largest bucket and every tuned one; auto only
            # picks among backends that passed
            self.bit_exact = verify_backends(
                self.model, list(self.backends.values()), probe)
        self.auto: AutoSelector | None = None
        if backend == "auto":
            # the whole ladder at startup, so that no served request pays
            # a calibration
            self.auto = AutoSelector(self.backends, self.bit_exact)
            for bucket in self.scheduler.buckets:
                self.auto.calibrate(torch.from_numpy(
                    np.ascontiguousarray(probe[:bucket], np.float32)))
            backend = self.auto.choice[self.scheduler.max_bucket]
        self.backend = self.backends[backend]
        # use_backend("auto") after pinning a backend restores this one
        self._auto_saved = self.auto

    def use_backend(self, name: str) -> None:
        """Switch the DWN datapath (the step caches are kept): a backend
        name pins it; ``"auto"`` returns to per-bucket selection, with the
        startup calibration if there was one (needs the startup
        verification)."""
        if self.family != "dwn":
            raise ValueError("use_backend switches a DWN datapath")
        name = serving_datapath(name)
        if name == "auto":
            if self.auto is None:
                if not self.bit_exact:
                    raise ValueError("auto-select needs the startup "
                                     "verification (verify=True)")
                self.auto = self._auto_saved or AutoSelector(
                    self.backends, self.bit_exact)
                self._auto_saved = self.auto
            return
        if name not in self.backends:
            raise ValueError(f"unknown serving backend {name!r}; "
                             f"registered: {available_backends()}")
        self.auto = None
        self.backend = self.backends[name]

    @property
    def name(self) -> str:
        return self.cfg.name if self.family == "lm" else self.model.arch_name

    def warmup(self, size: int | None = None) -> None:
        """Run one step outside the request accounting — the first launch
        builds the CUDA kernels, and a DWN step's first call captures its
        CUDA graph.  DWN: the bucket ``size``-sample requests
        land in (default: the largest); LM: one request of ``size``
        sequences (default 1)."""
        if self.family == "lm":
            self._lm_step(self.make_request(size or 1, seed=self.seed))
            return
        bucket = self.scheduler.max_bucket if size is None else \
            self.scheduler.bucket_for(min(size, self.scheduler.max_bucket))
        self._dwn_step(np.asarray(self.data.x_test[:bucket]))

    def _dwn_step(self, x: np.ndarray):
        """One bucket: the rows into the step (a CUDA graph's input on the
        card), the step, results back to the host at once (the copy back
        waits for the device; the next replay overwrites a graph's
        outputs)."""
        xh = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        backend = (self.auto.backend_for(xh) if self.auto is not None
                   else self.backend)
        counts, pred = backend.step_for(xh.shape[0])(xh)
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

    # ------------------------------------------------------------------
    # DWN head on the LM backbone (dwn_head=)
    # ------------------------------------------------------------------

    def _init_dwn_head(self, head, verify: bool) -> None:
        """Attach a packed DWN head on this engine's backbone: its pooled
        features (``workloads.lm_head.pool_features``, the pooling the
        head trained on) feed the head spec's serving backend, bound to
        the head's staged operands; ``verify`` checks its counts against
        ``apply_hard`` on the features of 8 seeded prompts."""
        from ..runtime.checkpoint import load_artifact
        if isinstance(head, DWNArtifact):
            art = head
        elif Path(str(head)).exists():
            art = load_artifact(head, device=self.device)
        else:
            art = DWNArtifact(resolve_spec(head))
        if art.stage == "spec":
            data = load_workload(art.spec.workload, 512, 64, seed=self.seed,
                                 device=self.device)
            art.fit(data.x_train, seed=self.seed)
        if art.stage == "trained":
            art.freeze()
        art.pack(self.device)
        name = serving_datapath(art.spec.datapath)
        if name not in available_backends():
            raise ValueError(f"a DWN head serves on one backend, not "
                             f"{art.spec.datapath!r}; registered: "
                             f"{available_backends()}")
        self.head_artifact = art
        self._head_backend = BoundBackend(get_backend(name),
                                          art.serving_model())
        if verify:
            rng = np.random.default_rng(self.seed)
            toks = rng.integers(0, self.cfg.vocab_size,
                                (8, self.prompt_len)).astype(np.int32)
            feats, counts, _ = self._head_forward(toks)
            oracle = apply_hard(art.frozen, feats)
            self.head_bit_exact = bool(torch.equal(counts.float(),
                                                   oracle.float()))
            if not self.head_bit_exact:
                raise RuntimeError(
                    f"the {name} DWN head disagrees with the apply_hard "
                    f"oracle on this backbone's features; refusing to serve")

    @torch.no_grad()
    def _head_forward(self, tokens):
        """tokens (B, S) -> (features (B, 16) float32, counts, pred) on the
        device; on the card counts and pred are the step's graph outputs,
        which its next replay overwrites."""
        from ..workloads.lm_head import head_features
        toks = torch.as_tensor(np.asarray(tokens)).to(self.device)
        feats = head_features(self.params, self.cfg, toks)
        counts, pred = self._head_backend(feats)
        return feats, counts, pred

    def _head_step(self, batch: dict) -> dict:
        """One classify request: tokens -> backbone features -> the DWN
        head -> {"counts", "pred", "features"} on the host."""
        if self.head_artifact is None:
            raise ValueError("no DWN head attached: construct with "
                             "dwn_head=...")
        feats, counts, pred = self._head_forward(batch["tokens"])
        self._head_served += int(feats.shape[0])
        return {"counts": counts.cpu().numpy(), "pred": pred.cpu().numpy(),
                "features": feats.cpu().numpy()}

    def _lm_or_head_step(self, batch: dict) -> dict:
        if isinstance(batch, dict) and batch.get("classify"):
            return self._head_step(batch)
        return self._lm_step(batch)

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

    def make_request(self, size: int, seed: int = 0, *,
                     classify: bool = False):
        """One request payload, drawn with ``numpy.random.default_rng
        (seed)``: DWN, ``size`` feature rows of the test split; LM, a batch
        ``{"tokens": (size, prompt_len) int32}`` of uniform token ids (the
        reference draws them with ``jax.random``, which torch cannot
        reproduce; a ``classify`` request draws them as the reference
        does, with numpy).  ``classify``: LM engines with a ``dwn_head``,
        a request for the head instead of prefill and decode."""
        rng = np.random.default_rng(seed)
        if classify and self.head_artifact is None:
            raise ValueError("classify requests need dwn_head= at "
                             "construction")
        if self.family == "lm":
            batch = {"tokens": rng.integers(
                0, self.cfg.vocab_size,
                (size, self.prompt_len)).astype(np.int32)}
            if classify:
                batch["classify"] = True
            return batch
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
        request's is the dict of :meth:`_lm_step`, a classify request's
        that of :meth:`_head_step`."""
        t0 = time.perf_counter()
        if self.family == "lm":
            done = self.scheduler.drain_serial(self._lm_or_head_step)
            self._lm_stats.extend((r.result["prefill_s"],
                                   r.result["decode_s_per_tok"])
                                  for r in done if "prefill_s" in r.result)
        else:
            done = self.scheduler.drain_batched(self._monitored_step)
        self._drain_wall += time.perf_counter() - t0
        return done

    def _monitored_step(self, x: np.ndarray):
        """The DWN step with its wall time fed to the straggler monitor
        (the sync drain's half; the continuous loop reports through the
        same monitor)."""
        t0 = time.perf_counter()
        out = self._dwn_step(x)
        self.straggler.report(time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------------
    # continuous-batching async API (DWN only)
    # ------------------------------------------------------------------

    def start_serving(self, *, slo: SLOConfig | None = None) -> None:
        """Start the continuous-batching loop (a dedicated thread).

        Requests then stream in through :meth:`submit_async` and complete
        out of order via their futures; batch formation happens at step
        boundaries over the same bucket ladder (step cache and tuned
        configs shared with the sync facade).  Admission control's
        step-time estimates seed from the ``AutoSelector`` calibration
        when ``backend="auto"``, else from one probe of the active backend
        at ``max_bucket``; every step refines them online.

        Every bucket of the ladder is stepped once on the served backend
        first, so that each step the session runs is built before the
        thread starts: on the card, each CUDA graph it replays is
        captured (a capture fails if another thread launches work
        meanwhile).  Do not change a tuned config during a session: the
        next step at that bucket would capture.
        """
        if self.family != "dwn":
            raise ValueError("continuous batching is the DWN path")
        if self._cont is not None:
            raise RuntimeError("serving loop already running")
        probe = self.data.x_test[:self.scheduler.max_bucket]
        for bucket in self.scheduler.buckets:
            self._dwn_step(probe[:bucket])
        if self.estimator is None:
            if self.auto is not None:
                self.estimator = estimator_from_calibration(self.auto)
            else:
                self.estimator = StepTimeEstimator()
                self.estimator.seed(
                    self.scheduler.max_bucket,
                    time_backend_step(self.backend, torch.from_numpy(
                        np.ascontiguousarray(probe, np.float32)), iters=2))
        self._cont = self._continuous(slo)
        self._cont.start()

    def _continuous(self, slo: SLOConfig | None, *,
                    timer=time.perf_counter) -> ContinuousScheduler:
        """The session's loop over this engine's DWN step, estimator and
        straggler monitor (``timer``: the loop's clock)."""
        return ContinuousScheduler(
            self._dwn_step, max_bucket=self.scheduler.max_bucket,
            min_bucket=self.scheduler.min_bucket, slo=slo,
            estimator=self.estimator, monitor=self.straggler, timer=timer)

    def stop_serving(self, *, drain: bool = True) -> None:
        """Stop the loop; ``drain=True`` serves the queue first.  Loop
        counters survive in :meth:`report` (sessions accumulate).  Raises
        if a step failed during the session."""
        if self._cont is None:
            raise RuntimeError("serving loop not running")
        cont, self._cont = self._cont, None
        try:
            cont.stop(drain=drain)
        finally:
            self._end_session(cont)

    def _end_session(self, cont: ContinuousScheduler) -> None:
        self._async_done.extend(cont.completed)
        self._async_counters = cont.counters()

    @contextlib.contextmanager
    def serve(self, *, slo: SLOConfig | None = None):
        """Context manager over one continuous-batching session::

            with engine.serve(slo=SLOConfig(deadline_default_ms=50)):
                req = engine.submit_async(xb, deadline_ms=20)
                res = req.future.result()      # ServeResult
        """
        self.start_serving(slo=slo)
        try:
            yield self
        finally:
            self.stop_serving()

    def submit_async(self, payload: Any, *,
                     deadline_ms: float | None = None, priority: int = 0,
                     timeout: float | None = None) -> AsyncRequest:
        """Admit one request into the continuous-batching loop.

        Requires :meth:`start_serving` / :meth:`serve`.  Returns the
        :class:`AsyncRequest`; its ``future`` resolves to a
        ``ServeResult`` — ``ok`` with ``value == (counts, pred)``, or
        typed shed when the deadline was unmeetable (admission), expired
        in queue, or missed at completion.  Raises ``QueueFull`` after
        ``timeout`` when backpressure applies.
        """
        if self._cont is None:
            raise RuntimeError("submit_async needs the serving loop: use "
                               "engine.serve()")
        payload = np.asarray(payload)
        return self._cont.submit(payload, payload.shape[0],
                                 deadline_ms=deadline_ms,
                                 priority=priority, timeout=timeout)

    def compile_counts(self) -> dict[str, dict[int, int]]:
        """Per-backend {bucket: steps built} (CUDA graphs captured on the
        card); DWN only, empty for LM."""
        if self.family != "dwn":
            return {}
        return {name: dict(b.compiles)
                for name, b in self.backends.items() if b.compiles}

    def report(self) -> dict:
        """JSON-able serving report over everything served so far.

        ``throughput_samples_per_s`` is samples (DWN) or sequences (LM) per
        wall-clock second (sync drains + async session wall);
        ``latency.{queue,compute,total}_ms`` are per-request millisecond
        percentiles (p50/p99/p999) over *served* requests — shed requests
        are excluded from latency and counted in ``shed``;
        ``queue_depth`` / ``shed`` / ``straggler`` cover both serving
        modes; ``async`` holds the last session's loop counters with the
        estimator's per-bucket ``step_estimates_ms``; LM ``prefill_s`` and
        ``decode_s_per_tok`` are seconds.
        """
        async_all = list(self._async_done)
        async_counters = dict(self._async_counters)
        if self._cont is not None:
            async_all += list(self._cont.completed)
            async_counters = self._cont.counters()
        async_ok = [r for r in async_all if r.shed is None]
        shed = [r for r in async_all if r.shed is not None]
        reqs = list(self.scheduler.completed) + async_ok
        served = sum(r.size for r in reqs)
        wall = self._drain_wall + async_counters.get("session_wall_s", 0.0)
        shed_by: dict[str, int] = {}
        for r in shed:
            shed_by[r.shed] = shed_by.get(r.shed, 0) + 1
        finished = len(reqs) + len(shed)
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
            "queue_depth": {
                "pending": self.scheduler.pending
                + (self._cont.pending if self._cont is not None else 0),
                "max_requests": max(
                    self.scheduler.max_pending,
                    async_counters.get("queue_depth_max_requests", 0)),
            },
            "shed": {
                "requests": len(shed),
                "rate": round(len(shed) / finished, 4) if finished
                else 0.0,
                "by_reason": shed_by,
            },
            "straggler": {
                "window": len(self.straggler.times),
                "events": len(self.straggler.events),
                "last_z": round(self.straggler.events[-1].z, 2)
                if self.straggler.events else None,
            },
        }
        if async_counters:
            out["async"] = async_counters
            if self.estimator is not None:
                out["async"]["step_estimates_ms"] = \
                    self.estimator.snapshot()
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
            if self.head_artifact is not None:
                out["dwn_head"] = {
                    "spec": self.head_artifact.spec.to_dict(),
                    "spec_fingerprint":
                        self.head_artifact.spec.fingerprint(),
                    "artifact_stage": self.head_artifact.stage,
                    "bit_exact_vs_oracle": self.head_bit_exact,
                    "served": self._head_served,
                    "datapath": self._head_backend.name,
                    "cuda_graphs": self._head_backend.graphed,
                }
            return out
        out.update({
            "mode": "dwn-classify",
            "datapath": ("auto" if self.auto is not None
                         else self.backend.name),
            "backends": available_backends(),
            "bit_exact_vs_oracle": self.bit_exact,
            "buckets": list(self.scheduler.buckets),
            "compiles": self.compile_counts(),
            # which backends replay a CUDA graph per bucket; the others
            # run their steps eagerly
            "cuda_graphs": {name: b.graphed
                            for name, b in self.backends.items()},
            "luts": self.spec.luts,
            "bits_per_feature": self.spec.bits,
            "spec": self.spec.to_dict(),
            "spec_fingerprint": self.spec.fingerprint(),
            "artifact_stage": self.artifact.stage,
        })
        if self.model.tuned_configs:
            out["tuned_configs"] = {int(b): c.to_dict() for b, c in
                                    self.model.tuned_configs.items()}
        if self.auto is not None:
            out["auto"] = {
                "choice": dict(self.auto.choice),
                "configs": {b: (c.to_dict() if c else None)
                            for b, c in self.auto.configs.items()},
                "timings_ms": {b: {n: round(t * 1e3, 4)
                                   for n, t in times.items()}
                               for b, times in self.auto.timings.items()},
            }
        return out


__all__ = ["ServingEngine"]
