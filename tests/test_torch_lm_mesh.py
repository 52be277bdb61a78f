"""The transformer's families over several ranks (tensor parallelism and
FSDP on a ("data", "model") ``DeviceMesh``, expert parallelism, sharded
restore), held on gloo ranks on the CPU against the reference's model
functions at the same tp on one device.

Each spawn starts its ranks as processes of their own (one torch thread
each) joined by a ``file://`` rendezvous; the ranks import torch and the
port only.  This process computes the reference's side in JAX and hands
it over as ``.npz``: the reduced qwen3-8b's params at tp
(``init_params(PRNGKey(0), cfg, tp)``, compiled with
``xla_allow_excess_precision`` off, as ``tests/test_torch_lm_tp.py``
does), a prompt, the prefill's last logits and two greedy decode steps'
(the reference's own argmax tokens fed to both packages), and
``moe_apply``'s outputs at ``ep=False`` and ``ep=True``.  Five spawns:
(1, 2), (1, 4), (2, 2), (1, 3) and the CLIs on (1, 2).

Bars: logits within 0.05 of the largest reference logit (the tp tests'
gate); ``moe_apply``'s output within 2e-2 of its largest value and its
aux loss within 1e-6 relative (``tests/test_torch_lm_zoo.py``'s); the
mesh's train steps against the one-rank port at the same tp: losses
within 1e-3 relative, the grad norm within 5e-3 relative and the params
within 3 * lr * steps (the ``lm_train`` card phase's bars: the mesh sums
bf16 partial products in another order, and Adam's first steps move a
weight by about lr whatever the size of its gradient); the grad norm
equal on every rank; restored leaves bit for bit; ``CommDebugMode``'s
counts equal to ``roofline.analyze.collective_account``'s, kind by kind.
"""

import dataclasses
import functools
import io
import json
import os
import socket
import subprocess
import sys
import textwrap
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim.adam import AdamState, leaves  # noqa: E402
from repro_torch.runtime import checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
STRICT = {"xla_allow_excess_precision": False}
LOGITS_REL = 0.05
LOSS_REL = 1e-3
NORM_REL = 5e-3
LR = 3e-4
B, S, STEPS = 4, 16, 2
ARCH = "qwen3-8b"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(script: str, world: int, work: Path, tag: str, *,
           launcher_env: bool = False) -> list[dict]:
    """Run ``script`` on ``world`` gloo ranks in ``work`` (argv: rank,
    world, the rendezvous file, the rank's output JSON); each rank's JSON
    result.  ``launcher_env``: the variables torchrun sets, for the
    CLIs, which join the group themselves."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_AUTOTUNE="0")
    if launcher_env:
        env.update(WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()))
    init = work / f"rendezvous-{tag}"
    outs = [work / f"{tag}-rank{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(init),
         str(outs[r])], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(o.read_text()) for o in outs]


# ---------------------------------------------------------------------------
# the reference's side, as flat numpy arrays
# ---------------------------------------------------------------------------

def _flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


@functools.lru_cache(maxsize=None)
def _ref_serving(tp: int, impls=("masked", "pallas")) -> dict:
    """The reduced qwen3-8b at ``tp``: its params, a prompt of B x S
    tokens, and for each attn_impl of ``impls`` the prefill's last logits
    and two greedy decode steps' logits (with the tokens each step is
    fed)."""
    jcfg = jget_arch(ARCH).reduced()
    mod = JA.module_for(jcfg)
    jp = jax.jit(lambda k: mod.init_params(k, jcfg, tp=tp))(
        jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, **_flat(jax.tree.map(np.asarray, jp), "params")}
    for impl in impls:
        c = dataclasses.replace(jcfg, attn_impl=impl)
        lg, cache = _strict(lambda p, t: mod.prefill(
            p, c, {"tokens": t}, tp=tp, cache_len=S + STEPS), jp, toks)(
            jp, toks)
        step = _strict(lambda p, ca, t: mod.decode_step(p, c, ca, t, tp=tp),
                       jp, cache, toks[:, :1])
        out[f"{impl}/logits0"] = np.asarray(lg, np.float32)
        for t in range(STEPS):
            nxt = np.asarray(jnp.argmax(lg[:, :jcfg.vocab_size], -1),
                             np.int32)[:, None]
            out[f"{impl}/feed{t}"] = nxt
            lg, cache = step(jp, cache, nxt)
            out[f"{impl}/logits{t + 1}"] = np.asarray(lg, np.float32)
    return out


def _ref_moe() -> dict:
    """The reference's ``moe_apply`` (4 experts, top 2, D 64, F 32; with
    ``ep=True`` the experts padded to 16, as its transformer pads them) on
    one device, bf16 input."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 16, 64),
                                     jnp.float32) * 0.5)
    out = {"moe/x": x}
    for ep in (False, True):
        p = JL.init_moe(jax.random.PRNGKey(4), 64, 32, 4,
                        pad_to=16 if ep else 0)
        y, aux = jax.jit(lambda p, x: JL.moe_apply(
            p, x.astype(jnp.bfloat16), top_k=2, num_real_experts=4,
            ep=ep))(p, x)
        out.update(_flat(jax.tree.map(np.asarray, p), f"moe{int(ep)}/p"))
        out[f"moe{int(ep)}/y"] = np.asarray(y, np.float32)
        out[f"moe{int(ep)}/aux"] = np.asarray(aux, np.float32)
    return out


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

PRELUDE = textwrap.dedent("""
    import copy, dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + init,
                            world_size=world, rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.models import api, parallel
    from repro_torch.models import transformer as T
    from repro_torch.optim.adam import AdamState, leaves

    CFG = get_arch("qwen3-8b").reduced()

    def load(name):
        return dict(np.load(name))

    def tree(ref, prefix):
        '''The nested dict of ``ref``'s arrays under ``prefix``.'''
        root = {}
        for key, v in ref.items():
            if key.startswith(prefix + "/"):
                *path, leaf = key[len(prefix) + 1:].split("/")
                d = root
                for p in path:
                    d = d.setdefault(p, {})
                d[leaf] = v
        return root

    def rel(got, want):
        got = got.float().numpy()
        return float(np.abs(got - want).max()
                     / max(np.abs(want).max(), 1e-3))

    def mesh_of(dp, mp):
        return init_device_mesh("cpu", (dp, mp),
                                mesh_dim_names=("data", "model"))

    def serving(mesh, ref, tp):
        '''The reference's params at ``tp`` on ``mesh``: for each impl the
        prefill's and two greedy decode steps' logits against the
        reference's (rel), the local cache's shape.'''
        res = {}
        for impl in ("masked", "pallas"):
            if f"{impl}/logits0" not in ref:
                continue
            cfg = dataclasses.replace(CFG, attn_impl=impl)
            params = api.shard_params(cfg, T.params_from_numpy(
                tree(ref, "params"), cfg), mesh)
            lg, cache = api.make_prefill(cfg, tp=tp, cache_len=18,
                                         mesh=mesh)(
                params, {"tokens": ref["tokens"]})
            rels = [rel(lg, ref[f"{impl}/logits0"])]
            decode = api.make_decode_step(cfg, tp=tp, mesh=mesh)
            for t in range(2):
                lg, cache = decode(params, cache, {
                    "tokens": torch.from_numpy(ref[f"{impl}/feed{t}"])})
                rels.append(rel(lg, ref[f"{impl}/logits{t + 1}"]))
            res[impl] = rels
            res["vocab"] = int(lg.shape[-1])
        res["cache"] = list(cache["k"].shape)
        return res

    def batches(n, seed=3):
        rng = np.random.default_rng(seed)
        return [{k: torch.from_numpy(rng.integers(
                    0, CFG.vocab_size, (4, 16)).astype(np.int64))
                 for k in ("tokens", "labels")} for _ in range(n)]

    def training(mesh, tp, steps=2):
        '''``steps`` train steps on ``mesh`` and on one rank at the same
        tp from one init: losses and grad norms, the largest param gap,
        whether the moments take the params' placements; the state.'''
        alone = T.init_params(CFG, tp=tp, seed=0, dtype=torch.float32)
        params = api.shard_params(CFG, copy.deepcopy(alone), mesh)
        step1, opt = api.make_train_step(CFG, tp=tp)
        state1 = opt.init(alone)
        step, opt = api.make_train_step(CFG, tp=tp, mesh=mesh)
        state = opt.init(params)
        got, want = [], []
        for b in batches(steps):
            _, _, m = step(params, state, b)
            got.append([float(m["loss"]), float(m["grad_norm"])])
            _, _, m = step1(alone, state1, b)
            want.append([float(m["loss"]), float(m["grad_norm"])])
        gap = max(float((a.full_tensor() - b).abs().max())
                  for a, b in zip(leaves(params), leaves(alone)))
        placed = all(str(m.placements) == str(p.placements)
                     for m, p in zip(leaves(state.mu), leaves(params)))
        return {"mesh": got, "alone": want, "param_gap": gap,
                "moments_placed": placed}, (params, state)

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()
""")

#: (1, 2): serving against the reference at tp 2; two train steps; the
#: MoE at ep=False and ep=True against the reference's; the trained
#: state saved (whole leaves beside it); a Supervisor restart
WORLD2 = PRELUDE + textwrap.dedent("""
    from repro_torch.models import layers as L
    from repro_torch.runtime import checkpoint
    from repro_torch.runtime.fault import FaultInjector, Supervisor
    from repro_torch.sharding import Partitioner, use_mesh
    ref = load("ref2.npz")
    mesh = mesh_of(1, 2)
    res = {"serving": serving(mesh, ref, 2)}
    res["training"], (params, state) = training(mesh, 2)
    checkpoint.save("ckpt", 2, (params, state))
    full = {str(i): whole(t) for i, t in enumerate(leaves((params, state)))}
    if rank == 0:
        np.savez("saved_at_world2.npz", **full)
    x = torch.from_numpy(np.array(ref["moe/x"])).to(torch.bfloat16)
    for ep in (0, 1):
        p = {k: torch.from_numpy(v)
             for k, v in tree(ref, f"moe{ep}/p").items()}
        sh = Partitioner(mesh).tree_shardings(p, L.axes_moe(ep=bool(ep)))
        local = parallel.gather_params(parallel.shard_tree(p, sh))
        with use_mesh(mesh):
            y, aux = L.moe_apply(local, x, top_k=2, num_real_experts=4,
                                 ep=bool(ep), d_ff=32)
        want, jaux = ref[f"moe{ep}/y"], float(ref[f"moe{ep}/aux"])
        res[f"moe{ep}"] = {
            "y_rel": rel(y, want), "aux_rel": abs(float(aux) - jaux) / jaux,
            "experts_here": int(local["w_gate"].shape[0]),
            "ff_here": int(local["w_gate"].shape[-1])}
    # a Supervisor over the mesh: a crash before step 3 restores step 2
    # onto the mesh and resumes, equal to a run that never crashed
    step, opt = api.make_train_step(CFG, tp=2, mesh=mesh)
    bs = batches(3, seed=7)

    def init():
        p = api.shard_params(CFG, T.init_params(
            CFG, tp=2, seed=0, dtype=torch.float32), mesh)
        return p, opt.init(p)
    inj = FaultInjector({2})

    def step_once(h):
        inj.maybe_crash(h.step)
        step(*h.state, bs[h.step])
        h.step += 1
        return h
    ps = api.param_shardings(CFG, api.abstract_params(CFG, 2), mesh)
    sup = Supervisor("sup", save_every=1,
                     shardings=(ps, AdamState(None, ps, ps)))
    sup.policy.backoff_s = 0.0
    h = sup.run(step_once, init_state=init, total_steps=3)
    p0, s0 = init()
    for b in bs:
        step(p0, s0, b)
    res["restart"] = {
        "restarts": sup.restarts, "steps": h.step,
        "dtensors": all(hasattr(t, "placements") for t in leaves(h.state)
                        if t.ndim),
        "equal": all(np.array_equal(whole(a), whole(b)) for a, b in
                     zip(leaves(h.state), leaves((p0, s0))))}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")

#: (1, 4): serving against the reference at tp 4; the world-2 state
#: restored onto (1, 4) and (2, 2)
WORLD4 = PRELUDE + textwrap.dedent("""
    from repro_torch.runtime import checkpoint
    res = {"serving": serving(mesh_of(1, 4), load("ref4.npz"), 4)}
    saved = load("saved_at_world2.npz")
    like = api.abstract_params(CFG, 2)
    state = AdamState(torch.zeros((), dtype=torch.int32), like, like)
    for dp, mp in ((1, 4), (2, 2)):
        mesh = mesh_of(dp, mp)
        ps = api.param_shardings(CFG, like, mesh)
        (params, opt), _ = checkpoint.restore(
            "ckpt", 2, (like, state),
            shardings=(ps, AdamState(None, ps, ps)))
        res[f"restore_{dp}x{mp}"] = {
            "equal": all(np.array_equal(whole(t), saved[str(i)]) for i, t
                         in enumerate(leaves((params, opt)))),
            "table_here": list(params["embed"]["table"].to_local().shape),
            "moment_placements": str(opt.mu["embed"]["table"].placements)}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")

#: (2, 2): serving against the reference at tp 2; two train steps; the
#: collectives of one prefill and one train step against the account
WORLD22 = PRELUDE + textwrap.dedent("""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.roofline.analyze import collective_account
    from repro_torch.sharding import AbstractMesh, Partitioner
    ref = load("ref2.npz")
    mesh = mesh_of(2, 2)
    res = {"serving": serving(mesh, ref, 2)}
    res["training"], _ = training(mesh, 2)
    KIND = {"all_reduce": "all-reduce", "reduce_scatter_tensor":
            "reduce-scatter", "all_gather_into_tensor": "all-gather"}

    def counted(cm):
        return {KIND[str(op).split(".")[-1].rstrip("')>")]: n
                for op, n in cm.get_comm_counts().items()}

    params = api.shard_params(CFG, T.init_params(CFG, tp=2, seed=0),
                              mesh)
    with CommDebugMode() as cm:
        api.make_prefill(CFG, tp=2, mesh=mesh)(
            params, {"tokens": ref["tokens"]})
    res["prefill_counts"] = counted(cm)
    params = api.shard_params(CFG, T.init_params(
        CFG, tp=2, seed=0, dtype=torch.float32), mesh)
    step, opt = api.make_train_step(CFG, tp=2, mesh=mesh)
    state = opt.init(params)
    b = batches(1)[0]
    with CommDebugMode() as cm:
        _, _, m = step(params, state, b)
    res["train_counts"] = counted(cm)
    res["grad_norm"] = float(m["grad_norm"])
    abstract = AbstractMesh(("data", "model"), (2, 2))
    aparams = api.abstract_params(CFG, 2)
    shardings = Partitioner(abstract).tree_shardings(aparams,
                                                     api.param_axes(CFG))
    for kind in ("prefill", "train"):
        acc = collective_account(CFG, ShapeConfig("c", 16, 4, kind),
                                 aparams, shardings, api.param_axes(CFG),
                                 rows_local=2)
        res[f"{kind}_account"] = acc.counts
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")

#: (1, 3): 2 KV heads over 3 ranks (kept whole, each rank's query heads
#: reading their own copies) and a vocabulary of 256 the ranks do not
#: divide (replicated): serving against the reference at tp 3
WORLD3 = PRELUDE + textwrap.dedent("""
    res = {"serving": serving(mesh_of(1, 3), load("ref3.npz"), 3)}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")

#: the CLIs under a launcher's environment on (1, 2): serve the dense,
#: MoE and VLM archs, and train qwen3-8b with checkpoints
CLI = textwrap.dedent("""
    import contextlib, io, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch import serve, train
    torch.set_num_threads(1)
    out = sys.argv[4]

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return json.loads(buf.getvalue().strip().splitlines()[-1])
    res = {}
    for arch in ("qwen3-8b", "granite-moe-3b-a800m", "llava-next-34b"):
        rep = run(serve.main, ["--arch", arch, "--reduced", "--device",
                               "cpu", "--model-parallel", "2", "--batch",
                               "2", "--prompt-len", "8", "--gen", "3"])
        res[arch] = {k: rep[k] for k in ("model_parallel", "devices",
                                         "sample", "family")}
    rep = run(train.main, ["--arch", "qwen3-8b", "--reduced", "--device",
                           "cpu", "--model-parallel", "2", "--steps", "3",
                           "--batch", "4", "--seq", "16", "--ckpt-dir",
                           "cli_ckpt", "--save-every", "2"])
    res["train"] = {k: rep[k] for k in ("model_parallel", "devices",
                                        "steps", "first_loss", "last_loss")}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The spawns' shared directory, with the reference's arrays."""
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "ref2.npz", **_ref_serving(2), **_ref_moe())
    np.savez(d / "ref4.npz", **_ref_serving(4))
    np.savez(d / "ref3.npz", **_ref_serving(3, ("masked",)))
    return d


@pytest.fixture(scope="module")
def world2(work):
    return _spawn(WORLD2, 2, work, "w2")


@pytest.fixture(scope="module")
def world4(work, world2):
    return _spawn(WORLD4, 4, work, "w4")


@pytest.fixture(scope="module")
def world22(work):
    return _spawn(WORLD22, 4, work, "w22")


@pytest.fixture(scope="module")
def world3(work):
    return _spawn(WORLD3, 3, work, "w3")


@pytest.fixture(scope="module")
def clis(work):
    return _spawn(CLI, 2, work, "cli", launcher_env=True)


# ---------------------------------------------------------------------------
# serving: the model functions against the reference at the mesh's tp
# ---------------------------------------------------------------------------

def _held_to_reference(outs, cache, vocab, impls=("masked", "pallas")):
    for out in outs:
        s = out["serving"]
        for impl in impls:
            assert max(s[impl]) < LOGITS_REL, (impl, s[impl])
        assert s["cache"] == cache and s["vocab"] == vocab
    assert all(o["serving"] == outs[0]["serving"] for o in outs)


def test_serving_on_1x2_matches_reference(world2):
    """(1, 2), tp 2: prefill and two greedy decode steps under ``masked``
    and ``pallas`` within 0.05 of the reference's logits on every rank
    (all equal); each rank's cache holds 1 of the 2 KV heads."""
    _held_to_reference(world2, [2, 4, 18, 1, 16], 256)


def test_serving_on_1x4_matches_reference(world4):
    """(1, 4), tp 4 (the 2 KV heads repeated to 4): within the gate, one
    KV head a rank."""
    _held_to_reference(world4, [2, 4, 18, 1, 16], 256)


def test_serving_on_2x2_matches_reference(world22):
    """(2, 2): FSDP over "data" and tp 2; each rank's cache holds its 2 of
    the 4 rows and 1 KV head; the logits of every row on every rank."""
    _held_to_reference(world22, [2, 2, 18, 1, 16], 256)


def test_serving_on_1x3_with_kv_whole_and_vocab_replicated(world3):
    """(1, 3), tp 3: 4 query heads padded to 6, 2 of them a rank, whose
    KV heads (2, kept whole) each rank reads one a query head; the
    vocabulary of 256 not split over 3 (the partitioner's fallback), so
    no logits gather.  ``masked`` within the gate."""
    _held_to_reference(world3, [2, 4, 18, 2, 16], 256, ("masked",))


def test_other_families_over_a_model_axis_raise_naming_item_9b5():
    """Queue 1 item 9b.5 is ported: mamba2, recurrentgemma and whisper run
    over a model axis (``tests/test_torch_lm_mesh_families.py``), and no
    refusal names the item.  What still raises: ``api.make_*(mesh=)`` for
    params laid out at a tp that the mesh's "model" axis disagrees with
    (every LM family), and for a DWN arch, which runs data-parallel
    through the serving engine and ``train_dwn_batch`` instead."""
    assert set(api.MESH_FAMILIES) == {"dense", "moe", "vlm", "ssm",
                                      "hybrid", "encdec"}
    # anything with a DeviceMesh's axis names and sizes stands in for one:
    # the layout is refused before a collective runs
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: (1, 2)[i])
    for arch in ("qwen3-8b", "mamba2-1.3b", "recurrentgemma-2b",
                 "whisper-large-v3"):
        cfg = get_arch(arch).reduced()
        for make in (api.make_prefill, api.make_decode_step,
                     api.make_train_step):
            with pytest.raises(ValueError, match="laid out at tp 4") as err:
                make(cfg, tp=4, mesh=mesh)
            assert "9b.5" not in str(err.value)
    for make in (api.make_prefill, api.make_train_step):
        with pytest.raises(ValueError, match="data-parallel"):
            make(get_arch("dwn-jsc-lg2400"), mesh=mesh)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-7b", "qwen3-14b",
                                  "phi3-mini-3.8b", "granite-moe-3b-a800m",
                                  "llava-next-34b", "qwen3-8b-reduced"])
@pytest.mark.parametrize("tp", [2, 3, 4, 8, 16])
def test_each_rank_reads_the_kv_heads_of_its_query_heads(arch, tp):
    """Exact, every layout regime at the full archs' head counts: model
    rank r's query heads are the global heads [r Hp/tp, (r+1) Hp/tp); the
    KV heads ``layers.local_kv`` gives it, read at the local GQA ratio,
    are the global heads those query heads read; the local shapes pass
    K10's wrapper checks (the local query heads a multiple of the local
    KV heads, the head dim one of ``HEAD_DIMS``).  Where the reference's
    layout pads the query heads to no multiple of the KV heads it keeps
    whole (qwen3-8b's 32 over 8 at tp 3: 33), neither package's attention
    runs it at any tp; the layout is the reference's all the same."""
    from repro_torch.kernels.flash_attn.kernel import HEAD_DIMS
    from repro_torch.models import layers as TL
    cfg = (get_arch("qwen3-8b").reduced() if arch.endswith("-reduced")
           else get_arch(arch))
    layout = TL.make_head_layout(cfg.num_heads, cfg.num_kv_heads, tp)
    assert dataclasses.asdict(layout) == dataclasses.asdict(
        JL.make_head_layout(cfg.num_heads, cfg.num_kv_heads, tp))
    if layout.q_padded % layout.kv_padded:
        assert tp == 3 and layout.kv_padded == cfg.num_kv_heads
        return
    local = TL.local_layout(layout, tp)
    assert layout.q_padded == tp * local.q_padded
    assert local.q_padded % local.kv_padded == 0
    assert cfg.head_dim_ in HEAD_DIMS
    g, g_local = (layout.q_padded // layout.kv_padded,
                  local.q_padded // local.kv_padded)
    heads = torch.arange(layout.kv_padded).view(1, 1, -1, 1)
    for r in range(tp):
        kv = TL.local_kv(heads, layout, r, tp).view(-1)
        assert kv.numel() == local.kv_padded
        for j in range(local.q_padded):
            assert int(kv[j // g_local]) == (r * local.q_padded + j) // g


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_train_steps_on_the_mesh_match_one_rank(mesh, world2, world22):
    """Two ``make_train_step`` steps on the mesh against the one-rank port
    at tp 2 from one init: losses, grad norms and params within their
    bars; every rank the same loss and norm; Adam's moments laid out as
    the params."""
    outs = world2 if mesh == "1x2" else world22
    for out in outs:
        tr = out["training"]
        for (loss, norm), (loss1, norm1) in zip(tr["mesh"], tr["alone"]):
            assert abs(loss - loss1) <= LOSS_REL * loss1
            assert abs(norm - norm1) <= NORM_REL * norm1
        assert tr["param_gap"] <= 3 * LR * STEPS, tr["param_gap"]
        assert tr["moments_placed"]
        assert tr["mesh"] == outs[0]["training"]["mesh"]


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def test_moe_apply_over_ranks_matches_reference(world2):
    """The MoE on (1, 2) against the reference's ``moe_apply`` on one
    device: ``ep=False`` with 16 of the 32 hidden units a rank, and
    ``ep=True`` with 8 of the 16 experts a rank (the 4 live ones on rank
    0), whose float32 scatter-add combine is all-reduced."""
    for out in world2:
        for ep, here in ((0, (4, 16)), (1, (8, 32))):
            m = out[f"moe{ep}"]
            assert m["y_rel"] <= 2e-2, (ep, m)
            assert m["aux_rel"] <= 1e-6, (ep, m)
            assert (m["experts_here"], m["ff_here"]) == here


def test_moe_ep_on_one_device_matches_reference():
    """``moe_apply(ep=True)`` on one device (no mesh) against the
    reference's ``ep=True``: output within 2e-2 of its largest value, aux
    loss within 1e-6 relative; and ``ep=False`` alike."""
    from repro_torch.models import layers as TL
    ref = _ref_moe()
    x = torch.from_numpy(np.array(ref["moe/x"])).to(torch.bfloat16)
    for ep in (0, 1):
        p = {k.split("/")[-1]: torch.from_numpy(v) for k, v in ref.items()
             if k.startswith(f"moe{ep}/p/")}
        y, aux = TL.moe_apply(p, x, top_k=2, num_real_experts=4,
                              ep=bool(ep))
        want = ref[f"moe{ep}/y"]
        assert (np.abs(y.float().numpy() - want).max()
                <= 2e-2 * np.abs(want).max())
        jaux = float(ref[f"moe{ep}/aux"])
        assert abs(float(aux) - jaux) <= 1e-6 * jaux


# ---------------------------------------------------------------------------
# sharded restore
# ---------------------------------------------------------------------------

def test_state_saved_at_world2_restores_at_world4_and_world1(world2, world4,
                                                             work):
    """The trained state (params and Adam's moments) saved at world 2 by
    rank 0 alone (one committed step, no temporary directory left)
    restores with equal leaves onto (1, 4) and (2, 2) DTensors (the
    embedding's vocab rows split 4 ways, then 2; the moments laid out
    alike) and at world 1 as whole tensors."""
    assert sorted(p.name for p in (work / "ckpt").iterdir()) == [
        "step_00000002", "step_00000002.COMMITTED"]
    for out in world4:
        assert out["restore_1x4"]["equal"] and out["restore_2x2"]["equal"]
        assert out["restore_1x4"]["table_here"] == [64, 64]
        assert out["restore_2x2"]["table_here"] == [128, 32]
        assert out["restore_2x2"]["moment_placements"] == \
            "(Shard(dim=1), Shard(dim=0))"
    like = api.abstract_params(get_arch(ARCH).reduced(), 2)
    state = AdamState(torch.zeros((), dtype=torch.int32), like, like)
    tree, _ = checkpoint.restore(work / "ckpt", 2, (like, state))
    saved = np.load(work / "saved_at_world2.npz")
    for i, t in enumerate(leaves(tree)):
        np.testing.assert_array_equal(t.numpy(), saved[str(i)])


def test_supervisor_restarts_over_the_mesh(world2):
    """A crash before step 3 under ``Supervisor(shardings=)`` restores the
    step-2 checkpoint onto the (1, 2) mesh (DTensor leaves) and resumes:
    the state after 3 steps equal, bit for bit, to a run that never
    crashed."""
    for out in world2:
        r = out["restart"]
        assert r == {"restarts": 1, "steps": 3, "dtensors": True,
                     "equal": True}


# ---------------------------------------------------------------------------
# the collective account
# ---------------------------------------------------------------------------

def test_comm_counts_on_2x2_equal_the_account(world22):
    """``CommDebugMode`` over one prefill (4 x 16 tokens) and one train
    step on (2, 2) counts, kind by kind, what ``collective_account``
    prices for the same step: the prefill's 16 FSDP gathers, the logits'
    gathers over the vocabulary and the batch, the lookup's and four
    output projections' all-reduces; the train step's gathers once a step
    and the loss's logits gather, 16 gradient reduce-scatters, and the
    all-reduces of the replicated and model-partial gradients, the
    Megatron pairs (recomputed under remat), the loss and the norm."""
    for out in world22:
        assert out["prefill_counts"] == out["prefill_account"] == {
            "all-gather": 18, "all-reduce": 5}
        assert out["train_counts"] == out["train_account"] == {
            "all-gather": 17, "reduce-scatter": 16, "all-reduce": 34}
    assert len({o["grad_norm"] for o in world22}) == 1


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _cli_alone(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_clis_with_model_parallel_over_two_ranks(clis):
    """Under a launcher's environment on 2 ranks, ``launch/serve.py
    --model-parallel 2`` serves the dense, MoE and VLM archs at tp 2 (the
    report's ``model_parallel``) over 2 devices, every rank the same
    tokens; qwen3-8b's equal to one process's (its reduced layout at tp
    2 is tp 1's); ``launch/train.py --model-parallel 2`` with
    checkpoints trains 3 steps at tp 2, its first loss within 1e-3 of one
    process's."""
    for out in clis:
        for arch in ("qwen3-8b", "granite-moe-3b-a800m", "llava-next-34b"):
            rep = out[arch]
            assert (rep["model_parallel"], rep["devices"]) == (2, 2)
            assert rep == clis[0][arch]
        assert out["train"]["model_parallel"] == 2
        assert out["train"]["steps"] == 3
    alone = _cli_alone(serve.main, [
        "--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--batch", "2",
        "--prompt-len", "8", "--gen", "3"])
    assert alone["model_parallel"] == 1
    assert clis[0]["qwen3-8b"]["sample"] == alone["sample"]
    one = _cli_alone(train.main, [
        "--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--steps", "1",
        "--batch", "4", "--seq", "16"])
    first = clis[0]["train"]["first_loss"]
    assert abs(first - one["first_loss"]) <= LOSS_REL * one["first_loss"]
