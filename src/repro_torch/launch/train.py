"""Training CLI: the DWN branch of the reference's ``launch/train.py``.

DWN archs (``--arch dwn-jsc-lg`` or any name ``dwn.resolve_spec`` takes):
the arch resolves to a ``DWNSpec``, ``--workload`` (or the spec's own)
picks the dataset, and :class:`~repro_torch.training.ScanTrainer` trains
it; several ``--seeds`` train one after another on the card
(``train_dwn_batch``).  Prints one JSON report line with the reference's
keys, plus the device.  With ``--artifact-dir`` each trained model is
frozen, packed and saved as a ``DWNArtifact``.

LM archs are not trained by the port yet (ROADMAP.md Queue 1 item 8).

Runs on the CUDA card unless ``--device cpu`` is given.

Usage:
    python -m repro_torch.launch.train --arch dwn-jsc-lg --workload jsc
    python -m repro_torch.launch.train --arch dwn-jsc-sm --reduced \\
        --epochs 1 --device cpu
    python -m repro_torch.launch.train --arch dwn-jsc-md --reduced \\
        --epochs 4 --seeds 0,1,2,3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings

import numpy as np

from ..configs import list_archs
from ..configs.registry import NOT_PORTED as LM_NOT_PORTED
from ..device import resolve_device


def dwn_train(args) -> dict:
    """Train the DWN ``args.arch`` names; returns the report."""
    from ..dwn import DWNArtifact, resolve_spec
    from ..training import ScanTrainer, train_dwn_batch
    from ..workloads import get_workload

    device = resolve_device(args.device)
    spec = resolve_spec(args.arch)
    if args.workload is None:
        if spec.workload == "jsc":
            warnings.warn(
                "training a DWN without --workload falls back to the "
                "implicit JSC default; pass --workload jsc explicitly",
                DeprecationWarning, stacklevel=2)
    elif args.workload != spec.workload:
        spec = dataclasses.replace(spec, workload=args.workload)
    dcfg = spec.dwn_config()
    n_train = 4000 if args.reduced else 20000
    data = get_workload(spec.workload).load(
        n_train, max(1000, n_train // 4), seed=args.seed)
    n_train = data.x_train.shape[0]
    seeds = [int(s) for s in str(args.seeds).split(",") if s != ""]
    batch = args.batch if args.batch > 0 else 128
    epochs = args.epochs

    rep = {"arch": args.arch, "engine": "scan", "epochs": epochs,
           "batch": batch, "n_train": n_train, "seeds": seeds,
           "workload": spec.workload, "spec": spec.to_dict(),
           "spec_fingerprint": spec.fingerprint(), "device": str(device)}
    trained = []
    if len(seeds) == 1:
        trainer = ScanTrainer(dcfg, data, batch=batch, lr=args.lr,
                              seed=seeds[0], device=device)
        res = trainer.train(epochs, eval_every=args.eval_every,
                            verbose=not args.quiet)
        secs = [h["sec"] for h in res.history]
        trained.append((seeds[0], res.params, res.buffers,
                        res.soft_test_acc))
        rep.update({
            "soft_test_acc": [round(res.soft_test_acc, 4)],
            "epoch_s": round(float(np.median(secs)), 3) if secs else None,
            "steps_per_epoch": trainer.steps_per_epoch,
            "steps_per_s": round(
                trainer.steps_per_epoch / float(np.median(secs)), 1)
            if secs else None,
        })
    else:
        out = train_dwn_batch(dcfg, data, epochs=epochs, seeds=seeds,
                              batch=batch, lr=args.lr, device=device)
        trained.extend((s, r.params, r.buffers, r.soft_test_acc)
                       for s, r in zip(seeds, out.results))
        rep.update({
            "soft_test_acc": [round(r.soft_test_acc, 4)
                              for r in out.results],
            "vmapped": False,
            "data_parallel": out.data_parallel,
            "wall_s": round(out.wall_s, 3),
            "epoch_s_per_model": round(
                out.wall_s / max(1, epochs) / len(seeds), 3),
            "steps_per_epoch": n_train // batch,
        })
    if args.artifact_dir:
        saved = []
        for seed, params, buffers, acc in trained:
            art = DWNArtifact(spec).adopt(params, buffers,
                                          note="launch.train")
            art.calibration.update(seed=seed, epochs=epochs,
                                   soft_test_acc=round(float(acc), 4))
            path = art.freeze().pack(device).save(
                f"{args.artifact_dir}/seed{seed}")
            saved.append({"seed": seed, "path": str(path),
                          "stage": art.stage})
        rep["artifacts"] = saved
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="DWN spec preset or arch name")
    ap.add_argument("--workload", default=None,
                    help="registered workload to train on (default: the "
                         "spec's own; omitting it for a JSC spec warns)")
    ap.add_argument("--reduced", action="store_true",
                    help="4000 training rows instead of 20000 (the model "
                         "keeps its width)")
    ap.add_argument("--batch", type=int, default=0,
                    help="batch size (default 128, the paper protocol)")
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="learning rate (default 1e-3, the paper protocol)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the dataset's seed")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds; more than one trains them "
                         "one after another")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="eval cadence (0 = after the last epoch only)")
    ap.add_argument("--artifact-dir", default="",
                    help="checkpoint each trained model as a DWNArtifact "
                         "(freeze + pack + save) under <dir>/seed<N>")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (default cuda; never falls back)")
    args = ap.parse_args(argv)
    if args.arch in list_archs() or args.arch in LM_NOT_PORTED:
        raise NotImplementedError(
            f"{args.arch} is an LM arch; the port trains DWNs only (LM "
            f"training is ROADMAP.md Queue 1 item 8)")
    print(json.dumps(dwn_train(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
