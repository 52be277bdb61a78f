"""Serving CLI: a thin argparse front-end over ``repro_torch.serving``.

DWN presets (``--arch dwn-jsc-lg`` or ``--spec``): batches of JSC feature
vectors are classified through the selected datapath backend
(``--backend fused-packed | packed-eager | float-oracle``); every
non-oracle backend is checked bit-exactly against the ``apply_hard``
oracle before serving starts.  ``--ragged`` draws request sizes in
[1, batch] so the scheduler's coalescing and padding run.

LM archs (``--arch qwen3-8b``): one request of ``--batch`` random prompts
of ``--prompt-len`` tokens, prefilled and decoded greedily for ``--gen``
tokens; ``--reduced`` serves the tiny same-family variant.  The arch's
``attn_impl`` decides prefill attention (qwen3-8b: ``masked``; the
engine takes an ``ArchConfig`` with ``attn_impl="pallas"`` for the
flash-attention kernel).

Runs on the CUDA card unless ``--device cpu`` is given.

Usage:
    python -m repro_torch.launch.serve --arch dwn-jsc-lg
    python -m repro_torch.launch.serve --arch dwn-jsc-sm --reduced --ragged
    python -m repro_torch.launch.serve --reduced --device cpu \\
        --spec '{"preset": "sm-50", "variant": "PEN", "input_bits": 9}'
    python -m repro_torch.launch.serve --arch qwen3-8b
    python -m repro_torch.launch.serve --arch qwen3-8b --reduced \\
        --device cpu --prompt-len 8 --gen 2

Prints one JSON report line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..configs import get_arch, list_archs
from ..dwn import DWNSpec, spec_presets
from ..serving import ServingEngine, available_backends
from ..serving.scheduler import next_pow2


def dwn_serve(target, args) -> dict:
    """Serve a synthetic request stream for ``target`` (a preset name or a
    ``DWNSpec``); returns the engine's report."""
    # --reduced shrinks the request volume, not the model
    n_train = 2000 if args.reduced else 20000
    requests = args.requests or (8 if args.reduced else 64)
    batch = args.batch or (256 if args.reduced else 4096)
    max_bucket = next_pow2(batch)
    engine = ServingEngine(
        target, backend=args.backend or None, max_bucket=max_bucket,
        min_bucket=min(8, max_bucket), n_train=n_train, seed=args.seed,
        device=args.device)
    engine.warmup(batch)
    rng = np.random.default_rng(args.seed)
    for _ in range(requests):
        size = int(rng.integers(1, batch + 1)) if args.ragged else batch
        engine.submit(engine.make_request(size,
                                          seed=int(rng.integers(2**31))))
    done = engine.drain()
    rep = engine.report()
    rep["batch"] = batch
    rep["ragged"] = bool(args.ragged)
    lat = rep.get("latency", {}).get("compute_ms", {})
    rep["latency_ms_p50"] = lat.get("p50")
    rep["latency_ms_p99"] = lat.get("p99")
    if done:
        rep["sample"] = np.asarray(done[0].result[1][:8]).tolist()
    return rep


def lm_serve(args) -> dict:
    """Prefill + greedy decode of one request of ``--batch`` prompts;
    returns the engine's report."""
    engine = ServingEngine(get_arch(args.arch), reduced=args.reduced,
                           prompt_len=args.prompt_len, gen=args.gen,
                           seed=args.seed, device=args.device)
    B = args.batch or 4
    engine.submit(engine.make_request(B, seed=args.seed))
    done = engine.drain()
    rep = engine.report()
    tokens = done[0].result["tokens"]
    if tokens.shape != (B, args.gen):
        raise RuntimeError(f"generated tokens have shape {tokens.shape}, "
                           f"not {(B, args.gen)}")
    rep["batch"] = B
    rep["sample"] = tokens[0, :8].tolist()
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="",
                    choices=[""] + spec_presets() + list_archs(),
                    help="registered DWN spec preset or LM arch")
    ap.add_argument("--spec", default="",
                    help='a DWNSpec as JSON, e.g. \'{"preset": "sm-50", '
                         '"variant": "PEN", "input_bits": 9}\'')
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
    ap.add_argument("--backend", default="",
                    choices=[""] + available_backends(),
                    help="DWN datapath backend (default: the spec's "
                         "datapath)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM: prompt tokens per sequence")
    ap.add_argument("--gen", type=int, default=16,
                    help="LM: tokens generated per sequence")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve (default cuda; never falls back)")
    args = ap.parse_args(argv)
    if bool(args.arch) == bool(args.spec):
        ap.error("give exactly one of --arch or --spec")
    if args.arch in list_archs():
        rep = lm_serve(args)
    else:
        target = DWNSpec(**json.loads(args.spec)) if args.spec else args.arch
        rep = dwn_serve(target, args)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
