"""Serving CLI: a thin argparse front-end over ``repro_torch.serving``.

Batches of JSC feature vectors are classified through the selected
datapath backend (``--backend fused-packed | packed-eager |
float-oracle``); every non-oracle backend is checked bit-exactly against
the ``apply_hard`` oracle before serving starts.  ``--ragged`` draws
request sizes in [1, batch] so the scheduler's coalescing and padding run.
Runs on the CUDA card unless ``--device cpu`` is given.

Usage:
    python -m repro_torch.launch.serve --arch dwn-jsc-lg
    python -m repro_torch.launch.serve --arch dwn-jsc-sm --reduced --ragged
    python -m repro_torch.launch.serve --reduced --device cpu \\
        --spec '{"preset": "sm-50", "variant": "PEN", "input_bits": 9}'

Prints one JSON report line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="", choices=[""] + spec_presets(),
                    help="registered DWN spec preset")
    ap.add_argument("--spec", default="",
                    help='a DWNSpec as JSON, e.g. \'{"preset": "sm-50", '
                         '"variant": "PEN", "input_bits": 9}\'')
    ap.add_argument("--reduced", action="store_true",
                    help="fewer, smaller requests (the model keeps its "
                         "width)")
    ap.add_argument("--batch", type=int, default=0,
                    help="request batch size (default 256 reduced, 4096 "
                         "full)")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default 8 reduced, 64 full)")
    ap.add_argument("--ragged", action="store_true",
                    help="draw request sizes uniformly in [1, batch]")
    ap.add_argument("--backend", default="",
                    choices=[""] + available_backends(),
                    help="datapath backend (default: the spec's datapath)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve (default cuda; never falls back)")
    args = ap.parse_args(argv)
    if bool(args.arch) == bool(args.spec):
        ap.error("give exactly one of --arch or --spec")
    target = DWNSpec(**json.loads(args.spec)) if args.spec else args.arch
    print(json.dumps(dwn_serve(target, args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
