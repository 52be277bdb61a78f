"""Training CLI: the reference's ``launch/train.py``, LM and DWN branches.

LM archs (``--arch qwen3-8b``, any registered LM arch): the model trained
on the synthetic ``TokenStream`` (``--batch`` sequences of ``--seq`` tokens a
step) with the reference's AdamW and global-norm clipping
(``models.api.make_train_step``), from float32 master weights, with the
straggler monitor and, given ``--ckpt-dir``, the checkpoint-restart
``Supervisor`` (the token stream's position rides in the checkpoint).
Prints one JSON line with the reference's keys, plus the device, the tp
that ran (``model_parallel``) and the ranks (``devices``).  Under
``torchrun`` the CLI joins the process group and every LM arch trains
over the ("data", "model") mesh, "model" of ``--model-parallel`` ranks
cut to the world: the params and Adam's moments are DTensors, the
batch's rows split over "data", and the ``Supervisor`` saves from rank
0 and restores each leaf onto its sharding.

DWN archs (``--arch dwn-jsc-lg`` or any name ``dwn.resolve_spec`` takes):
the arch resolves to a ``DWNSpec``, ``--workload`` (or the spec's own)
picks the dataset, and :class:`~repro_torch.training.ScanTrainer` trains
it; several ``--seeds`` train one after another on the card
(``train_dwn_batch``).  Prints one JSON report line with the reference's
keys, plus the device.  With ``--artifact-dir`` each trained model is
frozen, packed and saved as a ``DWNArtifact``.

Runs on the CUDA card unless ``--device cpu`` is given.

Usage:
    python -m repro_torch.launch.train --arch qwen3-8b --reduced --steps 20
    python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 20 --device cpu [--ckpt-dir /tmp/ckpt]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-8b --reduced --steps 20 --device cpu \\
        --model-parallel 2
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

from ..configs import assigned_archs, get_arch
from ..configs.registry import NOT_PORTED as LM_NOT_PORTED
from ..device import resolve_device


def lm_train(args) -> dict:
    """Train the LM ``args.arch`` for ``args.steps`` steps; returns the
    report."""
    import torch

    from ..data.tokens import TokenStream
    from ..models import api
    from ..optim.adam import AdamState
    from ..runtime.fault import PreemptionHandler, Supervisor, TrainHandle
    from ..runtime.straggler import StragglerMonitor
    from ..sharding.partition import axis_size, is_device_mesh
    from .mesh import init_from_env, make_host_mesh

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    init_from_env(device.type)
    mesh = make_host_mesh(args.model_parallel, device_type=device.type)
    tp = axis_size(mesh, "model")
    mesh = mesh if is_device_mesh(mesh) else None
    mod = api.module_for(cfg)
    step_fn, opt = api.make_train_step(cfg, tp=tp, mesh=mesh,
                                       opt=api.make_optimizer(args.lr))
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)
    monitor = StragglerMonitor()
    losses = []

    # the stub frontends' inputs are zeros, as the reference's CLI feeds
    stub = {"encdec": ("frames", cfg.enc_frames),
            "vlm": ("patches", cfg.num_patches)}.get(cfg.family)

    def make_batch(raw):
        batch = {k: torch.from_numpy(raw[k]).to(device)
                 for k in ("tokens", "labels")}
        if stub is not None:
            batch[stub[0]] = torch.zeros(
                (args.batch, stub[1], cfg.d_model), dtype=torch.bfloat16,
                device=device)
        return batch

    def step_once(handle):
        params, opt_state = handle.state
        stream.restore(handle.extra.get("data", {"step": handle.step}))
        raw = stream.next_batch()
        monitor.step_start()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             make_batch(raw))
        loss = float(metrics["loss"])
        monitor.step_end()
        losses.append(loss)
        handle.state = (params, opt_state)
        handle.step += 1
        handle.extra["data"] = stream.state()
        if handle.step % args.log_every == 0:
            print(f"step {handle.step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
        return handle

    def init():
        params = mod.init_params(cfg, tp=tp, seed=args.seed, device=device,
                                 dtype=torch.float32)
        if mesh is not None:
            params = api.shard_params(cfg, params, mesh)
        return params, opt.init(params)

    if args.ckpt_dir:
        shardings = None
        if mesh is not None:
            ps = api.param_shardings(cfg, api.abstract_params(cfg, tp),
                                     mesh)
            shardings = (ps, AdamState(None, ps, ps))
        # the steps update the state in place: a restart with no
        # checkpoint yet makes a fresh one
        sup = Supervisor(args.ckpt_dir, save_every=args.save_every,
                         preemption=PreemptionHandler(), device=device,
                         shardings=shardings)
        handle = sup.run(step_once, init_state=init,
                         total_steps=args.steps)
    else:
        handle = TrainHandle(init(), 0, {})
        while handle.step < args.steps:
            handle = step_once(handle)
    return {"arch": cfg.name, "steps": handle.step,
            "first_loss": losses[0] if losses else None,
            "last_loss": float(np.mean(losses[-5:])) if losses else None,
            "straggler_events": len(monitor.events),
            "device": str(device), "model_parallel": tp,
            "devices": mesh.size() if mesh is not None else 1}


def dwn_train(args) -> dict:
    """Train the DWN ``args.arch`` names; returns the report."""
    from ..dwn import DWNArtifact, resolve_spec
    from ..training import ScanTrainer, train_dwn_batch
    from ..workloads import get_workload

    device = resolve_device(args.device)
    if args.lr is None:
        args.lr = 1e-3       # the paper protocol
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
                    help="LM arch, or DWN spec preset or arch name")
    ap.add_argument("--workload", default=None,
                    help="DWN: registered workload to train on (default: "
                         "the spec's own; omitting it for a JSC spec warns)")
    ap.add_argument("--reduced", action="store_true",
                    help="LM: the tiny same-family model; DWN: 4000 "
                         "training rows instead of 20000 (the model keeps "
                         "its width)")
    ap.add_argument("--steps", type=int, default=100,
                    help="LM: optimizer steps")
    ap.add_argument("--batch", type=int, default=0,
                    help="batch size (default: 8 for LM archs, 128 for "
                         "DWN archs, the paper protocol)")
    ap.add_argument("--seq", type=int, default=128,
                    help="LM: tokens a sequence")
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: 3e-4 for LM archs, 1e-3 "
                         "for DWN archs, the paper protocol)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="LM: tensor-parallel degree over the process "
                         "group's ranks (under torchrun), cut to the "
                         "world; 1 without a group")
    ap.add_argument("--ckpt-dir", default="",
                    help="LM: checkpoint under this directory and resume "
                         "from its latest step (Supervisor)")
    ap.add_argument("--save-every", type=int, default=50,
                    help="LM: checkpoint cadence in steps")
    ap.add_argument("--log-every", type=int, default=10,
                    help="LM: print the loss every this many steps")
    ap.add_argument("--seed", type=int, default=0,
                    help="LM: the init and token stream's seed; DWN: the "
                         "dataset's seed")
    ap.add_argument("--epochs", type=int, default=4,
                    help="DWN: training epochs")
    ap.add_argument("--seeds", default="0",
                    help="DWN: comma-separated seeds; more than one trains "
                         "them one after another")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="DWN: eval cadence (0 = after the last epoch only)")
    ap.add_argument("--artifact-dir", default="",
                    help="DWN: checkpoint each trained model as a "
                         "DWNArtifact (freeze + pack + save) under "
                         "<dir>/seed<N>")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (default cuda; never falls back)")
    args = ap.parse_args(argv)
    if args.arch in assigned_archs() or args.arch in LM_NOT_PORTED:
        if args.lr is None:
            args.lr = 3e-4
        if args.batch <= 0:
            args.batch = 8
        rep = lm_train(args)
    else:
        rep = dwn_train(args)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
