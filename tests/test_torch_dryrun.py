"""The dry-run and roofline tooling (``repro_torch.roofline.analyze``,
``repro_torch.launch.dryrun``) against the reference's
(``repro.roofline.analyze``, ``repro.roofline.hlo_costs``, and the
arithmetic of ``repro.launch.dryrun``) on the CPU.

* ``model_flops``: exact, every arch x its shapes.
* The ring wire model: exact against ``parse_collectives`` on synthetic
  HLO lines of the same payload and group size, every kind.
* FLOPs: the port's step counted on the meta device
  (``FlopCounterMode``) against ``analyze_hlo(compiled.as_text(), 1)``
  of the reference's step compiled on one CPU device, for each family's
  reduced prefill and one dense train step.  Tolerance: exact (relative
  1e-12) once the named differences of the two programs are added, each
  counted from the shapes: the port's prefill unembeds the last position
  only (the reference all of them and keeps the last); the reference
  zero-pads the keys of every chunked attention to a multiple of its
  chunk (the port takes the last chunk short); the reference's SSD
  computes C B^T once a head, the port once a group.
* ``argument_bytes`` at (16, 16) and (2, 16, 16): the sum of the per-device
  shard bytes of params, Adam state and microbatched batch under the
  reference's own partitioner, for qwen3-8b and mixtral-8x7b train_4k.
* The collective account of the reduced qwen3-8b's prefill on a (2, 2)
  mesh: every collective written out below.
* ``--list`` against the reference's ``cell_supported``; ``main`` writes
  a record with the reference's keys under ``results/dryrun_torch/`` and
  never ``results/dryrun/``.

The reference's ``launch/dryrun.py`` is not imported: it sets XLA_FLAGS
for 512 host devices when imported.
"""

import dataclasses
import io
import json
import math
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import DWN_SHAPES as JDWN_SHAPES  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cell_supported as jcell_supported  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.registry import assigned_archs as jassigned  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.optim.adam import AdamState as JAdamState  # noqa: E402
from repro.roofline.analyze import model_flops as jmodel_flops  # noqa: E402
from repro.roofline.analyze import parse_collectives  # noqa: E402
from repro.roofline.hlo_costs import analyze_hlo  # noqa: E402
from repro.sharding.partition import Partitioner as JPartitioner  # noqa: E402
from repro.sharding.partition import logical as jlogical  # noqa: E402
from repro_torch.configs import (DWN_SHAPES, SHAPES, get_arch,  # noqa: E402
                                 list_archs)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.roofline import analyze as A  # noqa: E402
from repro_torch.sharding import AbstractMesh  # noqa: E402

FAMILY_ARCHS = ("qwen3-8b", "granite-moe-3b-a800m", "llava-next-34b",
                "mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3")
FLOPS_REL = 1e-12
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _DuckMesh:
    """What the reference's ``Partitioner.spec`` reads of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_model_flops_equal_reference(arch):
    """Exact, for every registered arch at each of its shapes."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shapes, jshapes = ((DWN_SHAPES, JDWN_SHAPES) if cfg.family == "dwn"
                       else (SHAPES, JSHAPES))
    for name, shape in shapes.items():
        for bwd in (False, True):
            assert A.model_flops(cfg, shape, include_backward=bwd) == \
                jmodel_flops(jcfg, jshapes[name], include_backward=bwd)


#: one synthetic HLO line of each kind (a format string of the group
#: count, the group size and the devices) and its payload bytes
HLO_LINES = {
    "all-reduce": ("%r = f32[1024]{{0}} all-reduce(%p), "
                   "replica_groups=[{g},{n}]<=[{t}], to_apply=%add", 4096),
    "all-gather": ("%g = bf16[8,512]{{1,0}} all-gather(%a), "
                   "replica_groups=[{g},{n}]<=[{t}], dimensions={{1}}", 8192),
    "reduce-scatter": ("%s = f32[2,128]{{1,0}} reduce-scatter(%x), "
                       "replica_groups=[{g},{n}]<=[{t}], dimensions={{0}}",
                       1024),
    "all-to-all": ("%t = bf16[4,64]{{1,0}} all-to-all(%x), "
                   "replica_groups=[{g},{n}]<=[{t}], dimensions={{0}}", 512),
    "collective-permute": ("%c = f32[16]{{0}} collective-permute(%y), "
                           "source_target_pairs={{0,1}}", 64),
}


@pytest.mark.parametrize("kind", sorted(HLO_LINES))
@pytest.mark.parametrize("n", [2, 8, 16, 256])
def test_wire_bytes_equal_reference_parse(kind, n):
    """Exact: the port's ring wire bytes of one collective of ``n``
    devices equal the reference's ``parse_collectives`` of the same op (a
    permute's group is the whole program: ``n`` devices)."""
    line, payload = HLO_LINES[kind]
    st = parse_collectives(line.format(g=256 // n, n=n, t=256), n)
    assert st.counts == {kind: 1} and st.payload_bytes == {kind: payload}
    assert A.wire_bytes(kind, payload, n) == st.wire_bytes
    assert A.COLLECTIVES == ("all-reduce", "all-gather", "reduce-scatter",
                             "all-to-all", "collective-permute")


def test_links_and_terms_at_the_h100_constants():
    """A group inside one 8-GPU node moves at NVLink's rate, one that
    leaves it at the inter-node rate; the terms' keys are the
    reference's, each term its count over its constant."""
    pod1 = AbstractMesh(("data", "model"), (16, 16))
    pod2 = AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    node = AbstractMesh(("data", "model"), (32, 8))
    assert A.link_of(pod1, ("model",)) == "internode"
    assert A.link_of(pod1, ("data",)) == "internode"
    assert A.link_of(node, ("model",)) == "nvlink"
    assert A.link_of(AbstractMesh(("data", "model"), (2, 2)),
                     ("data", "model")) == "nvlink"
    assert A.link_of(AbstractMesh(("pod", "data", "model"), (2, 1, 1)),
                     ("pod",)) == "nvlink"
    assert A.link_of(pod2, ("pod",)) == "internode"
    assert TM.INTERNODE_BW == 50e9 and TM.GPUS_PER_NODE == 8
    t = A.RooflineTerms(989e12, 3.35e12 / 2, {"nvlink": 450e9 / 4,
                                              "internode": 50e9 / 4}, 256)
    s = t.seconds()
    assert set(s) == {"compute_s", "memory_s", "collective_s", "bound",
                      "step_s_lower_bound"}
    assert s["compute_s"] == 1.0 and s["memory_s"] == 0.5
    assert s["collective_s"] == 0.5 and s["bound"] == "compute"
    assert s["step_s_lower_bound"] == 1.0


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO
# ---------------------------------------------------------------------------

def _padded_keys(Sq, Skv, chunk, cfg, batch):
    """FLOPs the reference spends on the zero keys that pad one chunked
    attention's Skv keys to a multiple of its chunk (scores and the
    weighted sum: 4 flops a query head, query, key and head dim; tp = 1,
    so no query head is padded)."""
    pad = -(-Skv // chunk) * chunk - Skv
    return 4 * batch * cfg.num_heads * cfg.head_dim_ * Sq * pad


def _named_differences(cfg, Bn, Sn):
    """The reference's FLOPs less the port's, named, for a prefill of
    Bn x Sn tokens at tp = 1."""
    D, V, c = cfg.d_model, cfg.vocab_padded(1), cfg.attn_chunk
    T = Sn + (cfg.num_patches if cfg.family == "vlm" else 0)
    out = {"unembedding of every position": 2 * Bn * (T - 1) * D * V}
    if cfg.family in ("dense", "moe", "vlm"):
        out["zero keys padding the last chunk"] = cfg.num_layers * \
            _padded_keys(T, T, c, cfg, Bn)
    if cfg.family == "encdec":
        Fr = cfg.enc_frames
        out["zero keys padding the last chunk"] = (
            cfg.enc_layers * _padded_keys(Fr, Fr, c, cfg, Bn)
            + cfg.num_layers * (_padded_keys(Sn, Sn, c, cfg, Bn)
                                + _padded_keys(Sn, Fr, c, cfg, Bn)))
    if cfg.family == "ssm":
        di = cfg.ssm_expand * D
        H, G, N = di // cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
        Q = min(cfg.ssm_chunk, Sn)
        nc = -(-Sn // Q)
        out["C B^T once a head, not once a group"] = \
            cfg.num_layers * 2 * Bn * nc * (H - G) * Q * Q * N
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_flops_equal_reference_hlo(arch):
    """Each family's reduced prefill (2 x 32 tokens, tp = 1): the port's
    meta-device FLOPs plus the named differences equal the reference's
    ``analyze_hlo`` of its compiled prefill (relative 1e-12)."""
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    shape, jshape = (ShapeConfig("p", S, B, "prefill"),
                     JShape("p", S, B, "prefill"))
    fn = JA.make_prefill(jcfg, 1, cache_len=S)
    compiled = jax.jit(fn).lower(JA.abstract_params(jcfg, 1),
                                 JA.batch_specs(jcfg, jshape)).compile()
    ref = analyze_hlo(compiled.as_text(), 1).flops
    _, counts = A.count_step(TA.make_prefill(cfg, tp=1, cache_len=S),
                             TA.abstract_params(cfg, 1),
                             TA.batch_specs(cfg, shape))
    diff = _named_differences(cfg, B, S)
    assert abs(counts.flops + sum(diff.values()) - ref) <= FLOPS_REL * ref, \
        (counts.flops, ref, diff)


def test_dense_train_step_flops_equal_reference_hlo():
    """One train step of the reduced qwen3-8b (2 x 32 tokens, remat on,
    AdamW): the same FLOPs as the reference's compiled step, with no
    named difference (the backward and remat's recomputed forward
    counted alike)."""
    cfg, jcfg = get_arch("qwen3-8b").reduced(), \
        jget_arch("qwen3-8b").reduced()
    assert cfg.remat
    jstep, jopt = JA.make_train_step(jcfg, 1)
    ap = JA.abstract_params(jcfg, 1)
    compiled = jax.jit(jstep).lower(
        ap, jax.eval_shape(jopt.init, ap),
        JA.batch_specs(jcfg, JShape("t", S, B, "train"))).compile()
    ref = analyze_hlo(compiled.as_text(), 1).flops
    step, opt = TA.make_train_step(cfg)
    params = TA.abstract_params(cfg, 1)
    _, counts = A.count_step(step, params, opt.init(params),
                             TA.batch_specs(cfg, ShapeConfig("t", S, B,
                                                             "train")))
    assert abs(counts.flops - ref) <= FLOPS_REL * ref, (counts.flops, ref)


# ---------------------------------------------------------------------------
# memory and collectives on the meshes
# ---------------------------------------------------------------------------

def _ref_shard_bytes(part, axes, shapes):
    """Per-device bytes of the reference's tree of ShapeDtypeStructs
    under its partitioner."""
    total = 0
    flat_axes = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(
        x, tuple) and hasattr(x, "name"))
    flat = jax.tree.leaves(shapes)
    assert len(flat_axes) == len(flat)
    for ax, s in zip(flat_axes, flat):
        spec = part.spec(tuple(ax), tuple(s.shape), ax.name)
        div = 1
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                div *= part.mesh.shape[a]
        total += math.prod(s.shape) * np.dtype(s.dtype).itemsize // div
    return total


@pytest.mark.parametrize("mesh", [(("data", "model"), (16, 16)),
                                  (("pod", "data", "model"), (2, 16, 16))],
                         ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b"])
def test_argument_bytes_equal_reference_specs(arch, mesh):
    """A device's ``argument_bytes`` of train_4k (params laid out at tp 16,
    Adam's step and moments, the batch in 4 microbatches) equal the sum of
    the shard bytes of the reference's abstract trees under the
    reference's partitioner."""
    names, sizes = mesh
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    cell = dryrun.build_cell(cfg, SHAPES["train_4k"],
                             AbstractMesh(names, sizes))
    jpart = JPartitioner(_DuckMesh(names, sizes))
    ap = JA.abstract_params(jcfg, 16)
    p_axes = JA.param_axes(jcfg)
    _, jopt = JA.make_train_step(jcfg, 16)
    o_axes = JAdamState(jlogical(name="opt.step"), p_axes, p_axes)
    micro = max(1, jcfg.train_microbatches)
    jshape = dataclasses.replace(JSHAPES["train_4k"],
                                 num_microbatches=micro)
    want = (_ref_shard_bytes(jpart, p_axes, ap)
            + _ref_shard_bytes(jpart, o_axes, jax.eval_shape(jopt.init, ap))
            + _ref_shard_bytes(jpart, JA.batch_axes(jcfg, jshape,
                                                     micro=True),
                               JA.batch_specs(jcfg, jshape, micro=True)))
    assert cell.argument_bytes == want
    assert cell.num_micro == micro == 4


def test_collective_account_on_a_2x2_mesh():
    """The reduced qwen3-8b's prefill of 4 x 32 tokens on a (2, 2)
    ("data", "model") mesh, params at tp 2 (d_model 64, 4 query heads
    over 2 KV heads of 16, d_ff 96, vocab padded to 256; float32): every
    weight but the norms is split over "data" on its d_model dim, so each
    is all-gathered over 2 devices once; the vocab-split lookup and the two
    output projections a layer all-reduce a device's 2 x 32 x 64 bf16
    activations over "model"; the last logits are gathered over the
    vocabulary and then over the batch.  All inside one node: NVLink."""
    cfg = get_arch("qwen3-8b").reduced()
    rec = dryrun.analyze_cell(cfg, ShapeConfig("p", 32, 4, "prefill"),
                              AbstractMesh(("data", "model"), (2, 2)))
    f32 = 4
    embed = 256 * 64 * f32 // 2                # gathered over data only
    per_layer = [64 * 4 * 16 * f32 // 2,       # wq (heads split on model)
                 64 * 2 * 16 * f32,            # wk (KV heads whole)
                 64 * 2 * 16 * f32,            # wv
                 4 * 16 * 64 * f32 // 2,       # wo
                 64 * 96 * f32 // 2,           # w_gate
                 64 * 96 * f32 // 2,           # w_up
                 96 * 64 * f32 // 2]           # w_down
    unembed = 64 * 256 * f32 // 2
    act = 2 * 32 * 64 * 2                      # rows_local 2, bf16
    logits_vocab, logits_batch = 2 * 256 * 2, 4 * 256 * 2
    gathers = ([embed] + per_layer * 2 + [unembed, logits_vocab,
                                           logits_batch])
    reduces = [act] * (1 + 2 * 2)
    coll = rec["collectives"]
    assert coll["counts"] == {"all-gather": len(gathers),
                              "all-reduce": len(reduces)} == \
        {"all-gather": 18, "all-reduce": 5}
    assert coll["payload_bytes"] == {"all-gather": sum(gathers),
                                     "all-reduce": sum(reduces)}
    wire = sum(gathers) / 2 + sum(reduces)     # (n-1)/n and 2(n-1)/n at n=2
    assert coll["wire_bytes_per_chip"] == wire
    assert coll["wire_bytes_by_link"] == {"nvlink": wire}
    assert rec["roofline"]["collective_s"] == wire / 450e9
    assert rec["split"] == "even" and rec["flops_per_chip"] > 0
    assert all(t["cites"].startswith("src/repro/") for t in coll["terms"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_list_agrees_with_reference_cell_supported():
    """``--list``: the reference's lines, from its ``cell_supported``."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert dryrun.main(["--list"]) == 0
    want = []
    for a in jassigned():
        for s in JSHAPES:
            ok, why = jcell_supported(jget_arch(a), JSHAPES[s])
            want.append(f"{a:24s} {s:12s} {'ok' if ok else 'SKIP: ' + why}")
    assert buf.getvalue().splitlines() == want


#: the reference record's keys but XLA's (compile_s, xla_cost_analysis)
REF_KEYS = {"cell", "arch", "shape", "mesh", "chips", "perf_variant",
            "params", "active_params", "flops_per_chip", "hbm_bytes_per_chip",
            "collectives", "memory_analysis", "roofline", "fallbacks",
            "lower_s", "model_flops_total", "useful_flops_ratio"}


def test_main_writes_records_under_results_dryrun_torch(tmp_path,
                                                        monkeypatch):
    """``main(["--arch", "qwen3-8b", "--shape", "decode_32k"])`` writes
    one record with the reference's keys under ``results/dryrun_torch/``
    (here a temporary one), caches it, and creates no
    ``results/dryrun/``; a skipped cell is a record too, and the moe_ep
    variant (item 9b.3, ported) a record whose account all-reduces the
    experts' combine over "model"."""
    out = tmp_path / "results" / "dryrun_torch"
    assert dryrun.RESULTS.name == "dryrun_torch"
    assert dryrun.RESULTS.parent.name == "results"
    monkeypatch.setattr(dryrun, "RESULTS", out)
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k"]) == 0
    rec = json.loads((out / "qwen3-8b__decode_32k__pod1.json").read_text())
    assert REF_KEYS <= set(rec)
    assert {"counts", "payload_bytes", "wire_bytes_per_chip"} <= \
        set(rec["collectives"])
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes", "peak_bytes"} <= \
        set(rec["memory_analysis"])
    assert rec["memory_analysis"]["temp_bytes"] is None
    assert rec["roofline"]["step_s_lower_bound"] > 0
    assert rec["chips"] == 256 and rec["mesh"] == {"data": 16, "model": 16}
    assert not (tmp_path / "results" / "dryrun").exists()
    assert sorted(p.name for p in out.iterdir()) == [
        "qwen3-8b__decode_32k__pod1.json"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        again = dryrun.run_cell("qwen3-8b", "decode_32k", multi_pod=False)
    assert buf.getvalue().startswith("[cached]") and again == rec
    skip = dryrun.run_cell("qwen3-8b", "long_500k", multi_pod=True)
    assert skip["skipped"] and "full-attention" in skip["reason"]
    assert dryrun.main(["--arch", "mixtral-8x7b", "--shape", "decode_32k",
                        "--variant", "moe_ep", "--tag", "ep"]) == 0
    ep = json.loads((out / "mixtral-8x7b__decode_32k__pod1__ep.json")
                    .read_text())
    assert "error" not in ep and ep["perf_variant"] == "moe_ep"
    combine = [t for t in ep["collectives"]["terms"]
               if t["what"] == "layers.0.moe.w_down: output projection "
                               "(forward)"]
    assert [(t["kind"], t["group"], t["count"]) for t in combine] == [
        ("all-reduce", ["model"], 1)]
    assert not (tmp_path / "results" / "dryrun").exists()
