"""The shared sweep pipeline: every grid point takes the same path.

The PyTorch counterpart of ``repro.sweep.pipeline``.  Each
:class:`~repro_torch.sweep.grid.SweepPoint` becomes one
``repro_torch.dwn.DWNArtifact`` (typed spec → trained → frozen → packed)
and every measurement axis reads from that artifact.  The runner

1. derives the point's :class:`~repro_torch.dwn.spec.DWNSpec` and builds
   its model once per unique (preset, T, placement) — TEN and PEN variants
   of the same model share weights, as in the paper, by ``adopt``-ing the
   shared trained state into each variant's artifact.  Points that agree
   on (preset, T) train through one ``train_dwn_batch`` call, whose
   members run one after another on the device (the port has no vmap);
2. computes **hard-inference accuracy** through ``apply_hard_packed``
   (the plain packed datapath, bit-exact vs the float oracle) on
   ``settings.device``;
3. scores **FPGA cost** via ``hw.cost.dwn_hw_report`` — the full
   encoder / LUT-layer / popcount / argmax breakdown;
4. times the **fused packed kernel** (K2, ``fused_tiles_kernel<false, _>``
   on a card; µs per batch, best of k) and the **serving engine**
   (samples/s through the scheduler + backend that production serving
   uses; on a card its steps replay CUDA graphs) on that exact config.

Results cache by config hash (``repro_torch.sweep.cache``) so re-running a
grid recomputes only new points.

Fidelity knobs live in :class:`SweepSettings`; beside the reference's
knobs it carries ``device`` (default ``"cuda"``: the runner raises
without a card unless ``device="cpu"``), which enters the cache key, so a
CPU result never serves a card run.  The default ``train_epochs=0``
trains nothing and relies on the correlation warmstart
(``core.warmstart``), which is enough for the hardware axes (TEN LUT
counts are training-invariant) and gives indicative — not paper-grade —
accuracies; raise ``--epochs`` for the real accuracy axis.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core import eval_accuracy_hard_packed, init_dwn, train_dwn
from ..core.model import DWNConfig
from ..core.warmstart import warmstart_dwn
from ..device import resolve_device
from ..dwn import DWNArtifact, DWNSpec
from ..hw.cost import dwn_hw_report
from ..kernels.fused import ops as fused_ops
from .artifacts import lut_error_pct, paper_reference
from .cache import SweepCache, point_key
from .grid import SweepPoint, load_grid
from .results import PointResult, SweepResult

#: the port's default cache root (the reference's is results/sweep_cache)
DEFAULT_CACHE_DIR = "results/sweep_cache_torch"


@dataclasses.dataclass(frozen=True)
class SweepSettings:
    """Fidelity/measurement knobs shared by every point of one sweep.

    Attributes:
      n_train / n_test: dataset split sizes (samples; per-workload caps
        in ``repro_torch.workloads`` may clamp them).
      data_seed / seed: dataset and model-init seeds (the init draws from
        ``torch.Generator().manual_seed(seed)`` on the host).
      train_epochs: gradient epochs per model; 0 = warmstart only.
      train_batch / lr: training shape.
      warmstart: correlation-based LUT init (``core.warmstart``).
      accuracy: run the packed hard-accuracy pass.
      kernel: time the fused packed kernel.
      kernel_batch: samples per timed kernel call.
      kernel_iters: timing repetitions (best-of, build excluded).
      serve: run the serving-engine throughput axis.
      serve_backend: datapath backend the engine times.
      serve_requests / serve_batch: request stream shape (count x size).
      device: where every axis runs ("cuda" or "cpu").
    """

    n_train: int = 4000
    n_test: int = 2000
    data_seed: int = 0
    seed: int = 0
    train_epochs: int = 0
    train_batch: int = 128
    lr: float = 1e-3
    warmstart: bool = True
    accuracy: bool = True
    kernel: bool = True
    kernel_batch: int = 256
    kernel_iters: int = 3
    serve: bool = False
    serve_backend: str = "fused-packed"
    serve_requests: int = 2
    serve_batch: int = 64
    device: str = "cuda"


class SweepRunner:
    """Runs grid points through the shared pipeline.

    Every point is materialized as ONE ``repro_torch.dwn.DWNArtifact``
    (spec → trained → frozen → packed on ``settings.device``); trained
    params are shared across points that differ only in TEN/PEN + input
    width (the paper's weight-sharing protocol) via the ``_models`` memo,
    and each variant's artifact ``adopt``s them before freezing to its own
    operating point.  Raises ``RuntimeError`` at construction when
    ``settings.device`` is ``"cuda"`` and no card is present.
    """

    def __init__(self, settings: SweepSettings):
        self.settings = settings
        self.device = resolve_device(settings.device)
        self._data: dict[str, object] = {}          # workload -> split
        self._test_x: dict[str, torch.Tensor] = {}  # workload -> on device
        self._models: dict[tuple, tuple] = {}       # (wl,preset,T,pl) -> (cfg,p,b)
        self._artifacts: dict[SweepPoint, DWNArtifact] = {}
        self._serve: dict[tuple, tuple] = {}        # point key -> (thru, p50)

    # -- data ----------------------------------------------------------

    def data_for(self, workload: str):
        """The workload's canonical split at the sweep's fidelity knobs
        (loaded once per workload per runner)."""
        if workload not in self._data:
            from ..workloads import load_workload
            s = self.settings
            self._data[workload] = load_workload(
                workload, s.n_train, s.n_test, seed=s.data_seed,
                device=self.device)
        return self._data[workload]

    @property
    def data(self):
        """The JSC split (the reference's alias)."""
        return self.data_for("jsc")

    def test_rows(self, workload: str) -> torch.Tensor:
        """The workload's test features on the device, copied there once
        per workload per runner."""
        if workload not in self._test_x:
            x = self.data_for(workload).x_test
            self._test_x[workload] = torch.from_numpy(x).to(self.device)
        return self._test_x[workload]

    # -- spec / model / artifact ---------------------------------------

    def spec_for(self, point: SweepPoint) -> DWNSpec:
        """The validated spec of one grid point (carries the serving
        datapath the point is timed on)."""
        return DWNSpec.from_point(point,
                                  datapath=self.settings.serve_backend)

    @staticmethod
    def _cfg_for(point: SweepPoint) -> DWNConfig:
        return DWNSpec.from_point(point).dwn_config()

    def _init_model(self, cfg: DWNConfig, workload: str = "jsc"):
        s = self.settings
        data = self.data_for(workload)
        gen = torch.Generator().manual_seed(s.seed)
        if s.warmstart:
            return warmstart_dwn(gen, cfg, data.x_train, data.y_train)
        return init_dwn(gen, cfg, data.x_train)

    def prepare_models(self, points) -> int:
        """Train the models several grid points share, ahead of the
        per-point loop.

        Points group by (workload, preset, T), as in the reference: members
        differ only in threshold placement, and a group trains through one
        ``repro_torch.training.train_dwn_batch`` call, whose members run one
        after another on the device.  Groups of one fall through to
        :meth:`model_for`.

        Returns the number of models trained in batched calls.
        """
        s = self.settings
        if s.train_epochs <= 0:
            return 0
        groups: dict[tuple, list] = {}
        for pt in points:
            key = (pt.workload, pt.preset, pt.bits, pt.placement)
            if key in self._models:
                continue
            grp = groups.setdefault((pt.workload, pt.preset, pt.bits), [])
            if key not in [k for k, _ in grp]:
                grp.append((key, pt))
        from ..training import train_dwn_batch
        trained = 0
        for (workload, _, _), members in groups.items():
            if len(members) < 2:
                continue
            cfgs = [self._cfg_for(pt) for _, pt in members]
            models = [self._init_model(c, workload) for c in cfgs]
            out = train_dwn_batch(
                cfgs[0], self.data_for(workload), epochs=s.train_epochs,
                seeds=[s.seed] * len(members), models=models,
                batch=s.train_batch, lr=s.lr, eval_final=False,
                device=self.device)
            for (key, _), cfg, res in zip(members, cfgs, out.results):
                self._models[key] = (cfg, res.params, res.buffers)
                trained += 1
        return trained

    def model_for(self, point: SweepPoint):
        """(DWNConfig, params, buffers) for the point's model shape —
        built once per unique (workload, preset, T, placement)."""
        key = (point.workload, point.preset, point.bits, point.placement)
        if key not in self._models:
            s = self.settings
            cfg = self._cfg_for(point)
            params, buffers = self._init_model(cfg, point.workload)
            if s.train_epochs > 0:
                res = train_dwn(cfg, self.data_for(point.workload),
                                epochs=s.train_epochs,
                                batch=s.train_batch, lr=s.lr, seed=s.seed,
                                params=params, buffers=buffers,
                                eval_every=0, verbose=False,
                                device=self.device)
                params, buffers = res.params, res.buffers
            self._models[key] = (cfg, params, buffers)
        return self._models[key]

    def artifact_for(self, point: SweepPoint) -> DWNArtifact:
        """The point's frozen :class:`DWNArtifact` — built once per point;
        trained state is adopted from the shared ``model_for`` memo, then
        frozen at the point's own operating point (PEN points quantize
        thresholds to the spec's (1, n) fixed-point grid)."""
        if point not in self._artifacts:
            _, params, buffers = self.model_for(point)
            art = DWNArtifact(self.spec_for(point))
            art.adopt(params, buffers, note="sweep").freeze()
            self._artifacts[point] = art
        return self._artifacts[point]

    # -- measurement axes ----------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _time_kernel(self, art: DWNArtifact) -> float:
        """Fused packed kernel wall time in µs per kernel_batch call.

        PEN points quantize inputs to the spec's (1, n) grid inside the
        timed step, exactly like the production fused backend — the
        kernel axis times the same datapath serving runs.  On a card each
        call launches K2 through its wrapper (eager: launch + kernel) and
        ends in ``torch.cuda.synchronize``; the first call, which builds
        and loads the library, is not timed.
        """
        s = self.settings
        packed = art.pack(self.device).packed
        inner = fused_ops.make_forward_packed(
            packed.thresholds, packed.mappings, packed.tables,
            art.spec.dwn_config().num_classes)
        frac = art.frozen.input_frac_bits

        def step(x):
            if frac is not None:
                from ..core.thermometer import quantize_fixed_point
                x = quantize_fixed_point(x, frac)
            return inner(x)

        xt = self.test_rows(art.spec.workload)
        reps = -(-s.kernel_batch // xt.shape[0])   # tile if the split is small
        x = xt.repeat(reps, 1)[:s.kernel_batch].contiguous()
        step(x)
        self._sync()                               # build outside timing
        best = float("inf")
        for _ in range(max(s.kernel_iters, 1)):
            t0 = time.perf_counter()
            step(x)
            self._sync()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6

    def _serve_point(self, point: SweepPoint) -> tuple[float, float]:
        """(throughput samples/s, p50 compute ms) through the engine —
        the point's own packed artifact is what gets served (PEN points
        serve the quantized datapath, bit-exact vs the oracle, which the
        engine checks at startup)."""
        key = (point.workload, point.preset, point.bits, point.placement,
               point.variant, point.input_bits)
        if key not in self._serve:
            from ..serving import ServingEngine
            s = self.settings
            engine = ServingEngine(
                self.artifact_for(point).pack(self.device),
                backend=s.serve_backend, max_bucket=s.serve_batch,
                min_bucket=min(8, s.serve_batch),
                n_train=min(s.n_train, 2000), seed=s.seed,
                device=self.device)
            engine.warmup(s.serve_batch)
            for i in range(s.serve_requests):
                engine.submit(engine.make_request(s.serve_batch, seed=i))
            engine.drain()
            rep = engine.report()
            self._serve[key] = (
                rep["throughput_samples_per_s"],
                rep["latency"]["compute_ms"]["p50"])
        return self._serve[key]

    # -- one point -----------------------------------------------------

    def run_point(self, point: SweepPoint) -> PointResult:
        """Run every enabled axis at one grid point."""
        s = self.settings
        art = self.artifact_for(point)
        rep = dwn_hw_report(art)
        paper = paper_reference(point)
        res = PointResult(
            point=point,
            luts=dict(rep.luts), total_luts=rep.total_luts,
            total_ffs=rep.total_ffs, delay_ns=round(rep.delay_ns, 3),
            fmax_mhz=round(rep.fmax_mhz, 1),
            distinct_comparators=rep.distinct_comparators,
            paper_luts=paper,
            lut_error_pct=lut_error_pct(rep.total_luts, paper),
            encoder_share=round(rep.luts.get("encoder", 0)
                                / max(rep.total_luts, 1), 4))
        if s.accuracy:
            res.accuracy = eval_accuracy_hard_packed(
                art.frozen, self.test_rows(point.workload),
                self.data_for(point.workload).y_test, device=self.device)
        if s.kernel:
            res.kernel_us = round(self._time_kernel(art), 1)
            res.kernel_batch = s.kernel_batch
        if s.serve:
            thru, p50 = self._serve_point(point)
            res.serve_throughput = thru
            res.serve_p50_ms = p50
            res.serve_backend = s.serve_backend
        return res


def scan_cache(points, settings: SweepSettings, cache: SweepCache,
               fresh: bool = False) -> dict[int, PointResult]:
    """Index -> cached :class:`PointResult` for every point whose key is
    present and loadable.  Corrupt entries and stale schemas read as
    misses (the point recomputes); ``fresh`` misses everything.
    """
    hits: dict[int, PointResult] = {}
    for i, point in enumerate(points):
        hit = None if fresh else cache.get(point_key(point, settings))
        if hit is not None:
            try:
                res = PointResult.from_dict(hit)
                res.cached = True
                hits[i] = res
            except (TypeError, KeyError):      # stale schema: recompute
                pass
    return hits


def persist_artifact(runner: SweepRunner, point: SweepPoint, key: str,
                     artifact_dir: str | None) -> str | None:
    """Save the point's packed :class:`~repro_torch.dwn.DWNArtifact` under
    ``artifact_dir/<label>-<key[:8]>`` via ``runtime.checkpoint.
    save_artifact`` (atomic, sha256-verified).  Returns the checkpoint
    path, or None when ``artifact_dir`` is unset."""
    if not artifact_dir:
        return None
    from pathlib import Path

    from ..runtime.checkpoint import save_artifact
    art = runner.artifact_for(point)
    art.pack(runner.device)
    safe = point.label.replace("/", "_").replace("@", "")
    dest = Path(artifact_dir) / f"{safe}-{key[:8]}"
    return str(save_artifact(dest, art))


def run_grid(grid: str | list, settings: SweepSettings | None = None, *,
             cache_dir: str | None = DEFAULT_CACHE_DIR,
             fresh: bool = False, log=None,
             artifact_dir: str | None = None) -> SweepResult:
    """Run a whole grid through the pipeline, with incremental caching.

    This is the **serial** in-process runner; the fault-tolerant parallel
    executor (worker processes, bounded restarts, straggler re-dispatch,
    preemption draining) is
    :func:`repro_torch.sweep.executor.run_grid_parallel` — both persist
    through the same cache, so runs can be freely resumed across the two.

    Args:
      grid: a named grid / JSON path (see ``grid.load_grid``) or an
        explicit list of :class:`SweepPoint`.
      settings: fidelity knobs; defaults to :class:`SweepSettings`() (on
        the card).
      cache_dir: result-cache root; None disables caching.
      fresh: ignore (but still refresh) the cache.
      log: optional ``print``-like progress callback.
      artifact_dir: when set, every computed point's packed artifact is
        checkpointed here (``runtime.checkpoint.save_artifact``).

    Returns the :class:`SweepResult` over every point.
    """
    settings = settings or SweepSettings()
    points = load_grid(grid) if isinstance(grid, str) else list(grid)
    name = grid if isinstance(grid, str) else "custom"
    cache = SweepCache(cache_dir)
    t_start = time.perf_counter()
    runner: SweepRunner | None = None
    hits = scan_cache(points, settings, cache, fresh)
    misses = [p for i, p in enumerate(points) if i not in hits]
    if misses:                                 # lazy: all-hit runs are free
        runner = SweepRunner(settings)
        # train shape-compatible models of the uncached points, one
        # train_dwn_batch call per group, before the per-point loop
        n_batched = runner.prepare_models(misses)
        if log and n_batched:
            log(f"batch-trained {n_batched} models "
                f"({settings.train_epochs} epochs, one call per group)")
    out = []
    for i, point in enumerate(points):
        res = hits.get(i)
        if res is None:
            t0 = time.perf_counter()
            res = runner.run_point(point)
            key = point_key(point, settings)
            cache.put(key, res.to_dict())
            persist_artifact(runner, point, key, artifact_dir)
            if log:
                log(f"[{i + 1}/{len(points)}] {point.label}: "
                    f"{res.total_luts} LUTs "
                    f"({time.perf_counter() - t0:.1f}s)")
        elif log:
            log(f"[{i + 1}/{len(points)}] {point.label}: cached")
        out.append(res)
    executor = {"mode": "serial", "workers": 0,
                "computed": len(misses), "cache_hits": len(hits),
                "failed": [], "restarts": 0,
                "stragglers_redispatched": 0, "interrupted": False,
                "remaining": 0, "cache": dict(cache.stats),
                "wall_s": round(time.perf_counter() - t_start, 3)}
    return SweepResult(grid=name, settings=dataclasses.asdict(settings),
                       points=out, executor=executor)


__all__ = ["SweepRunner", "SweepSettings", "persist_artifact", "run_grid",
           "scan_cache"]
