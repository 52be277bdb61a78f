"""Serving CLI: a thin argparse front-end over ``repro_torch.serving``.

DWN presets (``--arch dwn-jsc-lg`` or ``--spec``): batches of JSC feature
vectors are classified through the selected datapath backend
(``--backend fused-packed | packed-eager | float-oracle``, or ``auto``,
which tunes the fused kernel per bucket and serves each bucket on the
fastest bit-exact backend); every non-oracle backend is checked
bit-exactly against the ``apply_hard`` oracle before serving starts.
``--ragged`` draws request sizes in [1, batch] so the scheduler's
coalescing and padding run.  ``--continuous`` serves the same stream
through the continuous-batching loop (scheduler thread, out-of-order
futures, optional ``--deadline-ms`` SLO) instead of the sync submit/drain
facade.  ``--workload`` serves a spec preset on another registered
workload; under ``torchrun`` (``WORLD_SIZE`` above 1: the CLI joins the
process group, NCCL on the card, gloo on the CPU) every rank serves the
stream and buckets split by rows over the ranks, unless
``--no-data-parallel`` is given.  With ``--continuous`` and data
parallelism, rank 0 runs the loop (its requests, its buckets, each
broadcast to the other ranks, which follow it) and reports the results;
the report's ``continuous_loop`` says which loop a rank ran.

LM archs (``--arch qwen3-8b``, or any of the reference's ten LM archs:
dense, MoE, VLM, SSM, hybrid, encoder-decoder): one request of
``--batch`` random prompts of ``--prompt-len`` tokens (with the stub
frontends' patch or frame embeddings for llava-next-34b and
whisper-large-v3), prefilled and decoded greedily for ``--gen`` tokens;
``--reduced`` serves the tiny same-family variant.  The arch's
``attn_impl`` decides prefill attention (qwen3-8b: ``masked``; the
engine takes an ``ArchConfig`` with ``attn_impl="pallas"`` for the
flash-attention kernel).  ``--dwn-head`` (a spec preset name such as
``dwn-lm-head`` or a ``DWNArtifact`` checkpoint path) attaches a DWN
classification head on the backbone's pooled features: the same drain
then serves the LM request and one ``classify`` request of ``--batch``
prompts, and the report carries ``dwn_head``.  Under ``torchrun`` the CLI
joins the process group (NCCL on the card, gloo on the CPU) and every LM
arch serves over the ("data", "model") mesh, "model" of
``--model-parallel`` ranks (cut to the world): every rank serves the
same request and reports the same tokens; ``model_parallel`` in the
report is the tp that ran.

Runs on the CUDA card unless ``--device cpu`` is given.

Usage:
    python -m repro_torch.launch.serve --arch dwn-jsc-lg
    python -m repro_torch.launch.serve --arch dwn-jsc-lg --backend auto
    python -m repro_torch.launch.serve --arch dwn-jsc-sm --reduced --ragged
    python -m repro_torch.launch.serve --arch dwn-jsc-lg --continuous \\
        --deadline-ms 50
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch dwn-jsc-sm --reduced --device cpu
    python -m repro_torch.launch.serve --reduced --device cpu \\
        --spec '{"preset": "sm-50", "variant": "PEN", "input_bits": 9}'
    python -m repro_torch.launch.serve --arch qwen3-8b
    python -m repro_torch.launch.serve --arch qwen3-8b --reduced \\
        --device cpu --prompt-len 8 --gen 2
    python -m repro_torch.launch.serve --arch qwen3-8b --dwn-head dwn-lm-head
    torchrun --nproc-per-node 1 -m repro_torch.launch.serve \\
        --arch qwen3-8b --model-parallel 1
    torchrun --nproc-per-node 1 -m repro_torch.launch.serve \\
        --arch mamba2-1.3b --model-parallel 1
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch dwn-jsc-sm --reduced --device cpu --continuous
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch qwen3-8b --reduced --device cpu --model-parallel 2
    python -m repro_torch.launch.serve --arch whisper-large-v3 --reduced \
        --device cpu --prompt-len 8 --gen 2

Prints one JSON report line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from ..configs import assigned_archs, get_arch
from ..dwn import DATAPATH_ALIASES, DWNSpec, dwn_names, resolve_spec
from .mesh import init_from_env
from ..serving import ServingEngine, available_backends
from ..serving.scheduler import next_pow2


def dwn_serve(target, args) -> dict:
    """Serve a synthetic request stream for ``target`` (a preset name or a
    ``DWNSpec``), through the sync facade or, with ``--continuous``, the
    continuous-batching loop; returns the engine's report."""
    if args.workload is not None:
        spec = resolve_spec(target)
        if args.workload != spec.workload:
            # validated override: the preset must exist for that workload
            target = dataclasses.replace(spec, workload=args.workload)
    # --reduced shrinks the request volume, not the model
    n_train = 2000 if args.reduced else 20000
    requests = args.requests or (8 if args.reduced else 64)
    batch = args.batch or (256 if args.reduced else 4096)
    max_bucket = next_pow2(batch)
    engine = ServingEngine(
        target, backend=args.backend or None, max_bucket=max_bucket,
        min_bucket=min(8, max_bucket), n_train=n_train, seed=args.seed,
        device=args.device, data_parallel=not args.no_data_parallel)
    engine.warmup(batch)
    rng = np.random.default_rng(args.seed)
    payloads = []
    for _ in range(requests):
        size = int(rng.integers(1, batch + 1)) if args.ragged else batch
        payloads.append(engine.make_request(
            size, seed=int(rng.integers(2**31))))
    if args.continuous:
        # futures resolve out of order while the loop keeps steps in
        # flight; a deadline makes admission control and shedding part of
        # the run.  A follower of a data-parallel engine runs the leader's
        # buckets until the leader stops.
        results = []
        with engine.serve():
            if engine.continuous_loop != "follower":
                pending = [engine.submit_async(
                    p, deadline_ms=args.deadline_ms or None)
                    for p in payloads]
                results = [r.future.result() for r in pending]
        done = [r for r in results if r.ok]
    else:
        for p in payloads:
            engine.submit(p)
        done = engine.drain()
    rep = engine.report()
    rep["batch"] = batch
    rep["ragged"] = bool(args.ragged)
    rep["continuous"] = bool(args.continuous)
    # the datapath's (compute) latency per step; queue wait, which grows
    # with the pre-submitted stream, stays under "latency"
    lat = rep.get("latency", {}).get("compute_ms", {})
    rep["latency_ms_p50"] = lat.get("p50")
    rep["latency_ms_p99"] = lat.get("p99")
    if done:
        first = done[0].value if args.continuous else done[0].result
        rep["sample"] = np.asarray(first[1][:8]).tolist()
    return rep


def lm_serve(args) -> dict:
    """Prefill + greedy decode of one request of ``--batch`` prompts, and
    with ``--dwn-head`` one classify request of as many; returns the
    engine's report."""
    engine = ServingEngine(get_arch(args.arch), reduced=args.reduced,
                           prompt_len=args.prompt_len, gen=args.gen,
                           seed=args.seed, device=args.device,
                           model_parallel=args.model_parallel,
                           dwn_head=args.dwn_head or None)
    B = args.batch or 4
    engine.submit(engine.make_request(B, seed=args.seed))
    if args.dwn_head:
        engine.submit(engine.make_request(B, seed=args.seed + 1,
                                          classify=True))
    done = engine.drain()
    rep = engine.report()
    tokens = done[0].result["tokens"]
    if tokens.shape != (B, args.gen):
        raise RuntimeError(f"generated tokens have shape {tokens.shape}, "
                           f"not {(B, args.gen)}")
    rep["batch"] = B
    rep["sample"] = tokens[0, :8].tolist()
    if args.dwn_head:
        head = [r for r in done if "pred" in r.result]
        if not head or head[0].result["pred"].shape != (B,):
            raise RuntimeError("the classify request was not served")
        rep["head_sample"] = head[0].result["pred"][:8].tolist()
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="",
                    choices=[""] + dwn_names() + assigned_archs(),
                    help="DWN spec preset or arch name, or LM arch")
    ap.add_argument("--spec", default="",
                    help='a DWNSpec as JSON, e.g. \'{"preset": "sm-50", '
                         '"variant": "PEN", "input_bits": 9}\'')
    ap.add_argument("--workload", default=None,
                    help="DWN: registered workload to serve (jsc | mnist "
                         "| lm-head; default: the spec's own)")
    ap.add_argument("--dwn-head", default="",
                    help="LM: attach a packed DWN classification head (a "
                         "DWNArtifact checkpoint path or a spec preset "
                         "name, e.g. dwn-lm-head) and serve a classify "
                         "request beside the LM one in the same engine")
    ap.add_argument("--reduced", action="store_true",
                    help="DWN: fewer, smaller requests (the model keeps "
                         "its width); LM: the tiny same-family model")
    ap.add_argument("--batch", type=int, default=0,
                    help="request batch size (default: 4 for LM archs, "
                         "256/4096 reduced/full for DWN presets)")
    ap.add_argument("--requests", type=int, default=0,
                    help="DWN: number of requests (default 8 reduced, 64 "
                         "full)")
    ap.add_argument("--ragged", action="store_true",
                    help="DWN: draw request sizes uniformly in [1, batch]")
    ap.add_argument("--continuous", action="store_true",
                    help="DWN: serve through the continuous-batching loop "
                         "(scheduler thread + per-request futures) "
                         "instead of the sync submit/drain facade; data "
                         "parallel under torchrun, rank 0's loop leading")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="DWN with --continuous: per-request SLO deadline; "
                         "requests that provably cannot meet it are shed "
                         "at admission (0 = no deadline)")
    ap.add_argument("--backend", default="",
                    choices=["", "auto"] + available_backends()
                    + sorted(DATAPATH_ALIASES),
                    help="DWN datapath backend (default: the spec's "
                         "datapath); 'auto' tunes the fused kernel per "
                         "batch bucket at startup and serves each bucket "
                         "on the fastest bit-exact backend")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM: prompt tokens per sequence")
    ap.add_argument("--gen", type=int, default=16,
                    help="LM: tokens generated per sequence")
    ap.add_argument("--no-data-parallel", action="store_true",
                    help="DWN: serve alone on each rank even under an "
                         "initialised process group of several ranks")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="LM: tensor-parallel degree over the process "
                         "group's ranks (under torchrun), cut to the "
                         "world; 1 without a group")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true", default=True,
                    help="LM: greedy decoding (the only mode)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve (default cuda; never falls back)")
    args = ap.parse_args(argv)
    if bool(args.arch) == bool(args.spec):
        ap.error("give exactly one of --arch or --spec")
    if args.arch in assigned_archs():
        init_from_env(args.device)
        rep = lm_serve(args)
    else:
        target = DWNSpec(**json.loads(args.spec)) if args.spec else args.arch
        if not args.no_data_parallel:
            init_from_env(args.device)
        rep = dwn_serve(target, args)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
