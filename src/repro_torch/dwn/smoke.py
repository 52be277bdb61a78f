"""End-to-end artifact lifecycle smoke: the gate for ``repro_torch.dwn``.

The port's copy of the reference's ``repro.dwn.smoke``.  One run
exercises the whole API surface in order::

    DWNSpec → train (scan engine) → freeze → pack → hw_report → Verilog
            → serve (ServingEngine) → checkpoint save → load → bit-exact
              packed re-serve

and prints a single JSON record describing every stage.  Exits non-zero
if the checkpoint roundtrip is not bit-exact (packed serving
counts/predictions compared exactly) or any stage fails.  Training,
serving and the re-serve run on the CUDA card unless ``--device cpu``;
the re-serve compares the ``packed-eager`` backend (the reference's
``packed-xla``) before and after the roundtrip.

Usage:
    python -m repro_torch.dwn.smoke --out artifact_smoke.json --epochs 1
    python -m repro_torch.dwn.smoke --preset sm-10 --variant TEN --epochs 0
    python -m repro_torch.dwn.smoke --workload mnist --preset mnist-lg \
        --variant TEN --bits 16 --epochs 1
    python -m repro_torch.dwn.smoke --workload mnist --preset mnist-sm \
        --variant TEN --bits 8 --epochs 1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from ..device import resolve_device
from .artifact import DWNArtifact
from .spec import DWNSpec


def run(spec: DWNSpec, *, epochs: int, n_train: int, n_test: int,
        batch: int, seed: int, ckpt_dir: str, device=None,
        log=print) -> dict:
    """Drive one spec through the full lifecycle on ``device`` (default
    ``cuda``; raises without a card); returns the JSON-able stage-by-stage
    record (key ``roundtrip_bit_exact`` is the gate)."""
    from ..workloads import load_workload
    device = resolve_device(device)
    out: dict = {"spec": spec.to_dict(), "fingerprint": spec.fingerprint(),
                 "workload": spec.workload, "device": str(device)}
    data = load_workload(spec.workload, n_train, n_test, seed=seed,
                         device=device)

    log(f"[1/6] train: {spec.label}, {epochs} epoch(s)")
    art = DWNArtifact(spec).train(data, epochs=epochs, batch=batch,
                                  seed=seed, device=device)
    art.freeze().pack(device)
    out["stage"] = art.stage
    out["calibration"] = dict(art.calibration)

    log("[2/6] hw report")
    rep = art.hw_report()
    out["hw"] = {"variant": rep.variant, "total_luts": rep.total_luts,
                 "total_ffs": rep.total_ffs, "luts": dict(rep.luts),
                 "fmax_mhz": round(rep.fmax_mhz, 1),
                 "delay_ns": round(rep.delay_ns, 3)}
    out["verilog_lines"] = art.verilog().count("\n")

    log("[3/6] serve through the engine")
    from ..serving import ServingEngine
    engine = ServingEngine(art, max_bucket=64, min_bucket=8,
                           n_train=min(n_train, 512), seed=seed,
                           device=device)
    engine.warmup(64)
    for i in range(3):
        engine.submit(engine.make_request(64, seed=i))
    engine.drain()
    srep = engine.report()
    out["serve"] = {"datapath": srep["datapath"],
                    "throughput_samples_per_s":
                        srep["throughput_samples_per_s"],
                    "bit_exact_vs_oracle": srep["bit_exact_vs_oracle"]}

    log(f"[4/6] checkpoint -> {ckpt_dir}")
    path = art.save(ckpt_dir)
    out["checkpoint"] = str(path)

    log("[5/6] reload")
    art2 = DWNArtifact.load(ckpt_dir, device=device)
    out["reloaded_stage"] = art2.stage

    log("[6/6] bit-exact packed re-serve check")
    from ..serving.backends import BoundBackend, get_backend
    x = torch.from_numpy(np.ascontiguousarray(data.x_test[: min(64, n_test)]))
    b1 = BoundBackend(get_backend("packed-eager"), art.serving_model())
    b2 = BoundBackend(get_backend("packed-eager"), art2.serving_model())
    c1, p1 = (a.cpu().numpy() for a in b1(x))
    c2, p2 = (a.cpu().numpy() for a in b2(x))
    out["roundtrip_bit_exact"] = bool(np.array_equal(c1, c2)
                                      and np.array_equal(p1, p2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", default="jsc",
                    help="registered workload the spec trains/serves on "
                         "(jsc | mnist | ...; --preset must be one of "
                         "its tiers)")
    ap.add_argument("--preset", default="sm-50")
    ap.add_argument("--variant", default="PEN", choices=["TEN", "PEN"])
    ap.add_argument("--bits", type=int, default=64,
                    help="thermometer bits per feature T")
    ap.add_argument("--placement", default="distributive")
    ap.add_argument("--input-bits", type=int, default=9,
                    help="PEN input width (ignored for TEN)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--n-test", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--out", default="",
                    help="write the lifecycle JSON record here")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train and serve (default cuda; never "
                         "falls back)")
    args = ap.parse_args(argv)

    spec = DWNSpec(
        preset=args.preset, variant=args.variant, bits=args.bits,
        placement=args.placement,
        input_bits=args.input_bits if args.variant == "PEN" else None,
        workload=args.workload)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="dwn_artifact_")
    log = (lambda *a, **k: None) if args.quiet else print
    out = run(spec, epochs=args.epochs, n_train=args.n_train,
              n_test=args.n_test, batch=args.batch, seed=args.seed,
              ckpt_dir=ckpt, device=args.device, log=log)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0 if out["roundtrip_bit_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
