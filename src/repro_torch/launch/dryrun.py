"""Dry-run of every (arch x shape x mesh) cell on the meta device: the
PyTorch counterpart of the reference's ``repro.launch.dryrun``.

For each cell this builds the production mesh (abstract: axis names and
sizes), the params, optimizer state, batch and cache on the ``meta``
device (shapes only, nothing allocated) at the mesh's tp, their specs
from the logical-axis rules (``sharding.Partitioner``), and runs the
cell's step (a train step, a prefill or a decode step) on them under the
counters of ``roofline.analyze``: FLOPs, HBM bytes, the collectives the
specs need, and each chip's argument and output bytes.  The record goes
to ``results/dryrun_torch/<cell>.json`` (never the reference's
``results/dryrun/``), with the reference's keys but those of XLA's
compiler, which the port does not run (``compile_s``,
``xla_cost_analysis``, the ``.hlo.txt.gz`` beside it).  ``lower_s`` is
the seconds of the meta run.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
    python -m repro_torch.launch.dryrun --dwn
    python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from pathlib import Path

import torch

from ..configs import DWN_SHAPES, SHAPES, cell_supported, get_arch
from ..configs.registry import assigned_archs
from ..models import api
from ..roofline.analyze import (RooflineTerms, collective_account,
                                count_step, model_flops, shard_bytes,
                                spec_shards, tensor_bytes)
from ..sharding.partition import Partitioner, axis_names, logical
from .mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: the reference's ``--dwn`` sweep
DWN_ARCHS = ("dwn-jsc-sm10", "dwn-jsc-sm50", "dwn-jsc-md360",
             "dwn-jsc-lg2400", "dwn-jsc-lg2400-fused", "dwn-jsc-md360-fused")

VARIANTS = ("baseline", "logits_sharded", "serve_tp_only", "serve_bf16",
            "attn_tri", "scores_bf16", "moe_ep", "cf1")

#: (cfg, shape, tp, bf16 params) -> (result, StepCounts) of meta runs
#: made in this process
_META_RUNS: dict = {}

NOTHING_ALLOCATED = ("nothing is allocated on the meta device: the port "
                     "runs no compiler whose buffer plan could be read")


def _cell_id(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def shape_train_micro(cfg, shape) -> int:
    return max(1, cfg.train_microbatches) if shape.kind == "train" else 1


def _opt_state(state) -> dict:
    """Adam's state as a tree the partitioner walks."""
    return {"step": state.step, "mu": state.mu, "nu": state.nu}


def _opt_axes(p_axes) -> dict:
    """Moments shard like params (the reference's ``_opt_state_axes``)."""
    return {"step": logical(name="opt.step"), "mu": p_axes, "nu": p_axes}


def _rows_local(batch, shardings, *, micro: bool) -> int:
    """Batch rows one device holds of a microbatch (the whole batch
    without microbatches), from the tokens' (or features') spec."""
    key = "features" if "features" in batch else "tokens"
    t, sh = batch[key], shardings[key]
    d = 1 if micro else 0
    return t.shape[d] // spec_shards(sh.mesh, sh.spec)[d]


def _as_tensors(cache: dict) -> dict:
    """The cache with an int position (an LM's) as the 0-d int32 tensor
    the reference's holds, for its specs and bytes; the step itself reads
    the int."""
    return {k: (torch.empty((), dtype=torch.int32, device="meta")
                if isinstance(v, int) else v) for k, v in cache.items()}


def _bf16(tree):
    """The serving form: float32 leaves as bf16 (meta)."""
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(v) for v in tree]
    return tree.to(torch.bfloat16) if tree.dtype == torch.float32 else tree


@dataclasses.dataclass
class Cell:
    """One step of a cell, ready to run on the meta device: ``fn(*args)``
    and what the account and the memory figures read."""
    cfg: object
    shape: object
    mesh: object
    tp: int
    part: Partitioner
    fn: object
    args: tuple
    params: dict
    param_shardings: dict
    param_axes: dict
    argument_bytes: int
    rows_local: int
    num_micro: int
    cache_shardings: dict | None = None
    #: train: per-device bytes of the params and optimizer state, which
    #: the step returns laid out as they came in
    state_bytes: int = 0


def build_cell(cfg, shape, mesh, *, variants=frozenset(),
               rules=None) -> Cell:
    """The step of ``cfg`` at ``shape`` on ``mesh`` (an ``AbstractMesh``;
    tp is its "model" axis, 1 without one) and its arguments on the meta
    device: the params laid out at tp (bf16 under ``serve_bf16`` on a
    serving shape), and the optimizer state and microbatched batch
    (train) or the batch and cache (prefill, decode), each with its specs
    and the bytes one device holds of them."""
    names = axis_names(mesh)
    tp = mesh.shape["model"] if "model" in names else 1
    part = Partitioner(mesh, rules=rules or {})
    aparams = api.abstract_params(cfg, tp)
    if "serve_bf16" in variants and shape.kind != "train":
        aparams = _bf16(aparams)
    p_axes = api.param_axes(cfg)
    p_shard = part.tree_shardings(aparams, p_axes)
    micro = shape_train_micro(cfg, shape)
    arg_bytes = shard_bytes(aparams, p_shard)
    c_shard, state_bytes = None, 0
    if shape.kind == "train":
        fn, opt = api.make_train_step(cfg, tp=tp, num_micro=micro)
        aopt = opt.init(aparams)
        o_tree = _opt_state(aopt)
        o_shard = part.tree_shardings(o_tree, _opt_axes(p_axes))
        shp = dataclasses.replace(shape, num_microbatches=micro)
        bspecs = api.batch_specs(cfg, shp, micro=True)
        b_shard = part.tree_shardings(bspecs, api.batch_axes(cfg, shp,
                                                             micro=True))
        args = (aparams, aopt, bspecs)
        arg_bytes += shard_bytes(o_tree, o_shard)
        state_bytes = arg_bytes
    else:
        bspecs = api.batch_specs(cfg, shape)
        b_shard = part.tree_shardings(bspecs, api.batch_axes(cfg, shape))
        acache = api.abstract_cache(cfg, shape, tp)
        c_tree = _as_tensors(acache)
        c_shard = part.tree_shardings(c_tree, api.cache_axes(cfg, shape))
        if shape.kind == "prefill":
            fn = api.make_prefill(cfg, tp=tp, cache_len=shape.seq_len)
            args = (aparams, bspecs)
        else:
            fn = api.make_decode_step(cfg, tp=tp)
            args = (aparams, acache, bspecs)
            arg_bytes += shard_bytes(c_tree, c_shard)
    arg_bytes += shard_bytes(bspecs, b_shard)
    return Cell(cfg, shape, mesh, tp, part, fn, args, aparams, p_shard,
                p_axes, arg_bytes,
                _rows_local(bspecs, b_shard, micro=micro > 1), micro,
                c_shard, state_bytes)


def _output_bytes(cell: Cell, out, logits_sharded: bool) -> int:
    """Per-device bytes of the step's results: the params and optimizer
    state (train, laid out as they came in) and its metrics; or the
    logits (replicated, the reference's ``out_shardings`` None, or split
    over the vocabulary under ``logits_sharded``) and the cache."""
    if cell.shape.kind == "train":
        return cell.state_bytes + sum(tensor_bytes(v)
                                      for v in out[2].values())
    logits, cache = out
    split = cell.tp if logits_sharded and cell.cfg.family != "dwn" else 1
    return (tensor_bytes(logits) // split
            + shard_bytes(_as_tensors(cache), cell.cache_shardings))


def analyze_cell(cfg, shape, mesh, *, variants=frozenset(),
                 rules=None) -> dict:
    """Price one step of ``cfg`` at ``shape`` on ``mesh``
    (:func:`build_cell`): run it on the meta device under the counters and
    return the record's counts, memory, collectives and roofline terms."""
    cell = build_cell(cfg, shape, mesh, variants=variants, rules=rules)
    logits_sharded = "logits_sharded" in variants
    # the step's global counts depend on the params' layout, not on the
    # mesh: cells at one tp share one meta run
    key = (cfg, shape, cell.tp,
           "serve_bf16" in variants and shape.kind != "train")
    reused = key in _META_RUNS
    if not reused:
        _META_RUNS[key] = count_step(cell.fn, *cell.args)
    out, counts = _META_RUNS[key]
    out_bytes = _output_bytes(cell, out, logits_sharded)
    coll = collective_account(cfg, shape, cell.params, cell.param_shardings,
                              cell.param_axes, rows_local=cell.rows_local,
                              num_micro=cell.num_micro,
                              logits_sharded=logits_sharded)
    chips = mesh.size
    flops, hbm = counts.flops / chips, counts.hbm_bytes / chips
    terms = RooflineTerms(flops, hbm, coll.wire_by_link, chips)
    record = {"num_microbatches": cell.num_micro} \
        if shape.kind == "train" else {}
    record.update({
        "flops_per_chip": flops, "hbm_bytes_per_chip": hbm,
        "split": "even",
        "collectives": {"counts": coll.counts,
                        "payload_bytes": coll.payload_bytes,
                        "wire_bytes_per_chip": coll.wire_bytes,
                        "wire_bytes_by_link": coll.wire_by_link,
                        "terms": coll.terms},
        "memory_analysis": {
            "argument_bytes": cell.argument_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None, "generated_code_bytes": None,
            "peak_bytes": None, "null_reason": NOTHING_ALLOCATED},
        "roofline": terms.seconds(),
        "fallbacks": [dataclasses.asdict(f) for f in cell.part.fallbacks],
        "meta_ops": counts.ops, "lower_s": counts.seconds,
        "meta_run_reused": reused})
    if (cfg.attn_impl == "pallas" and cfg.swa_window is None
            and cfg.family in ("dense", "moe", "vlm")):
        record["attention_counted_as"] = (
            "the flash-attention kernel's plain version (kernels/flash_attn/"
            "ref.py: every query against every key, float32); the "
            "reference's hlo_costs counts its Pallas call as free")
    return record


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               perf_variant: str = "baseline", extra: dict | None = None):
    """One cell's record (the reference's ``lower_cell``), or its skip.

    perf_variant (comma-separated), as the reference applies them:
      * "logits_sharded": prefill/decode logits stay vocab-split on the
        model axis instead of being gathered;
      * "serve_tp_only": serving weights replicated over the data axes
        (the "embed" rule off), so no FSDP gathers on the serving path;
      * "serve_bf16": serving weights in bf16;
      * "attn_tri", "scores_bf16", "cf1": ``attn_impl="tri"``,
        ``attn_scores_bf16``, capacity factor 1.0;
      * "moe_ep": experts over the model axis (padded to a multiple of
        16), the reference's expert-parallel layout, whose combine the
        account all-reduces over "model".
    """
    cfg = get_arch(arch)
    shape = {**SHAPES, **DWN_SHAPES}[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"cell": _cell_id(arch, shape_name, multi_pod),
                "skipped": True, "reason": reason}
    variants = set(perf_variant.split(",")) if perf_variant else set()
    unknown = variants - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; known: "
                         f"{VARIANTS}")
    if "attn_tri" in variants:
        cfg = dataclasses.replace(cfg, attn_impl="tri")
    if "scores_bf16" in variants:
        cfg = dataclasses.replace(cfg, attn_scores_bf16=True)
    if "moe_ep" in variants:
        cfg = dataclasses.replace(cfg, moe_ep=True)
    if "cf1" in variants:
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = {}
    if "serve_tp_only" in variants and shape.kind != "train":
        rules["embed"] = None          # replicate the FSDP dim for serving
    record = {
        "cell": _cell_id(arch, shape_name, multi_pod),
        "arch": arch, "shape": shape_name,
        "mesh": dict(zip(mesh.axis_names, mesh.sizes)),
        "chips": mesh.size,
        "perf_variant": perf_variant,
        "params": cfg.num_params(),
        "active_params": cfg.num_active_params(),
    }
    record.update(analyze_cell(cfg, shape, mesh, variants=variants,
                               rules=rules))
    mf = model_flops(cfg, shape, include_backward=shape.kind == "train")
    record["model_flops_total"] = mf
    total = record["flops_per_chip"] * record["chips"]
    record["useful_flops_ratio"] = mf / total if total else 0.0
    if extra:
        record.update(extra)
    return record


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             force: bool = False, tag: str = "",
             perf_variant: str = "baseline") -> dict:
    RESULTS.mkdir(parents=True, exist_ok=True)
    cid = _cell_id(arch, shape_name, multi_pod) + (f"__{tag}" if tag else "")
    out = RESULTS / f"{cid}.json"
    if out.exists() and not force:
        rec = json.loads(out.read_text())
        print(f"[cached] {cid}: {rec.get('roofline', rec.get('reason', ''))}")
        return rec
    print(f"[lower ] {cid} ...", flush=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod,
                         perf_variant=perf_variant)
    except Exception as e:
        rec = {"cell": cid, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        out.write_text(json.dumps(rec, indent=2))
        print(f"[FAIL  ] {cid}: {rec['error']}", flush=True)
        return rec
    out.write_text(json.dumps(rec, indent=2, default=float))
    if rec.get("skipped"):
        print(f"[skip  ] {cid}: {rec['reason']}", flush=True)
    else:
        r = rec["roofline"]
        print(f"[ok    ] {cid}: bound={r['bound']} "
              f"c={r['compute_s']:.4f}s m={r['memory_s']:.4f}s "
              f"x={r['collective_s']:.4f}s (lower {rec['lower_s']:.1f}s)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dwn", action="store_true",
                    help="sweep the paper's DWN archs x DWN shapes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="perf-variant knobs, comma separated "
                         f"({','.join(VARIANTS[1:])})")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    if args.list:
        for a in assigned_archs():
            for s in SHAPES:
                ok, why = cell_supported(get_arch(a), SHAPES[s])
                print(f"{a:24s} {s:12s} {'ok' if ok else 'SKIP: ' + why}")
        return 0

    if args.dwn:
        failures = 0
        for a in DWN_ARCHS:
            for s in DWN_SHAPES:
                if a.endswith("-fused") and s == "dwn_train_1m":
                    continue          # fused variant is a serving datapath
                rec = run_cell(a, s, multi_pod=args.multi_pod,
                               force=args.force)
                failures += 1 if "error" in rec else 0
        print(f"done; failures={failures}")
        return 1 if failures else 0

    if args.all:
        failures = 0
        for a in assigned_archs():
            for s in SHAPES:
                rec = run_cell(a, s, multi_pod=args.multi_pod,
                               force=args.force)
                failures += 1 if "error" in rec else 0
        print(f"done; failures={failures}")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all/--dwn/--list)")
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   force=args.force, tag=args.tag,
                   perf_variant=args.variant)
    return 1 if "error" in rec else 0


__all__ = ["Cell", "DWN_ARCHS", "RESULTS", "VARIANTS", "analyze_cell",
           "build_cell", "lower_cell", "main", "run_cell",
           "shape_train_micro"]


if __name__ == "__main__":
    sys.exit(main())
