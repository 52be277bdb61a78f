"""mamba2, recurrentgemma and whisper over several ranks (tensor
parallelism and FSDP on a ("data", "model") ``DeviceMesh``, sharded
restore), held on gloo ranks on the CPU against the reference's model
functions at the same tp on one device.

The reduced archs: mamba2-1.3b (2 layers, d_inner 128: 8 SSM heads of
16, one B/C group of state 16, so 160 convolution channels), the hybrid
recurrentgemma-2b (3 layers: two RG-LRU blocks of width 64 and a local
MQA attention of 4 query heads over 1 KV head) and whisper-large-v3 (2
encoder and 2 decoder layers, 4 MHA heads, 12 frames); vocab 251, padded
to 256.  On (1, 2) and (1, 4) the model ranks divide the SSM heads, the
convolution's channels (misaligned with the channels a rank convolves:
80 a rank of which it needs 64 + 32 at tp 2), the RG-LRU width, the
heads and the vocabulary; on (1, 3) they divide none of mamba2's and
recurrentgemma's channels nor the vocabulary (the partitioner's
fallbacks replicate them and every rank runs the whole block), while
the attention heads (padded to 6) and the MLPs split.

As ``tests/test_torch_lm_mesh.py`` does it: each spawn starts its ranks
as processes of their own (one torch thread each) joined by a
``file://`` rendezvous, importing torch and the port only, and this
process computes the reference's side in JAX once and hands it over as
``.npz``: each arch's params at tp (``init_params(PRNGKey(0), cfg, tp)``,
its model functions compiled with ``xla_allow_excess_precision`` off), a
prompt of 4 x 16 tokens (with 12 frames for whisper), the prefill's last
logits and two greedy decode steps' (the reference's argmax tokens fed
to both packages).  Four spawns, one a mesh, each carrying the three
families: (1, 2) (serving, training, the per-leaf gradients, the state
saved, the CLIs), (1, 4) (serving, the state restored), (2, 2)
(serving, training, the collective counts) and (1, 3) (serving).

Bars: logits within 0.05 of the largest reference logit; train steps on
the mesh against the one-rank port at the same tp: losses within 1e-3
relative, the grad norm within 5e-3, the params within 3 * lr * steps
(the transformer's bars); with float32 products, each leaf's gradient
within 1e-4 of its largest value (floored at 1e-4: whisper's K biases
take none, since the softmax ignores a shift of every score) against
the one-rank port's, where a leaf whose partial gradient no rank sums
would be off by half; restored leaves bit for bit; ``CommDebugMode``'s
counts equal to ``collective_account``'s, kind by kind.
"""

import functools
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim.adam import AdamState, leaves  # noqa: E402
from repro_torch.runtime import checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3")
STRICT = {"xla_allow_excess_precision": False}
LOGITS_REL = 0.05
LOSS_REL = 1e-3
NORM_REL = 5e-3
GRAD_REL = 1e-4
LR = 3e-4
B, S, STEPS = 4, 16, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(script: str, world: int, work: Path, tag: str) -> list[dict]:
    """Run ``script`` on ``world`` gloo ranks in ``work`` (argv: rank,
    world, the rendezvous file, the rank's output JSON) under a timeout;
    each rank's JSON result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_AUTOTUNE="0")
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
def _ref_serving(arch: str, tp: int) -> dict:
    """The reduced ``arch`` at ``tp``: its params, a prompt of B x S
    tokens (whisper: and B x 12 frames), the prefill's last logits and two
    greedy decode steps' logits with the tokens each step is fed; keys
    under ``arch/``."""
    jcfg = jget_arch(arch).reduced()
    mod = JA.module_for(jcfg)
    jp = jax.jit(lambda k: mod.init_params(k, jcfg, tp=tp))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32)}
    if jcfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, jcfg.enc_frames, jcfg.d_model)) * 0.1).astype(np.float32)
    out = {f"{arch}/{k}": v for k, v in batch.items()}
    out.update(_flat(jax.tree.map(np.asarray, jp), f"{arch}/params"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lg, cache = _strict(lambda p, b: mod.prefill(
        p, jcfg, b, tp=tp, cache_len=S + STEPS), jp, jb)(jp, jb)
    step = _strict(lambda p, ca, t: mod.decode_step(p, jcfg, ca, t, tp=tp),
                   jp, cache, batch["tokens"][:, :1])
    out[f"{arch}/logits0"] = np.asarray(lg, np.float32)
    for t in range(STEPS):
        nxt = np.asarray(jnp.argmax(lg[:, :jcfg.vocab_size], -1),
                         np.int32)[:, None]
        out[f"{arch}/feed{t}"] = nxt
        lg, cache = step(jp, cache, nxt)
        out[f"{arch}/logits{t + 1}"] = np.asarray(lg, np.float32)
    return out


def _refs(tp: int) -> dict:
    return {k: v for arch in ARCHS for k, v in _ref_serving(arch, tp).items()}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

PRELUDE = textwrap.dedent("""
    import contextlib, copy, json, sys
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
    from repro_torch.models import layers as L
    from repro_torch.optim.adam import leaves
    from repro_torch.optim.grad import value_and_grad
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.annotate import use_mesh

    ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3")

    def cfg_of(arch):
        return get_arch(arch).reduced()

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

    def serving(mesh, ref, arch, tp):
        '''The reference's params at ``tp`` on ``mesh``: the prefill's and
        two decode steps' logits against the reference's (rel), the
        port's greedy tokens, the local cache's shapes.'''
        cfg = cfg_of(arch)
        mod = api.module_for(cfg)
        params = api.shard_params(cfg, mod.params_from_numpy(
            tree(ref, arch + "/params"), cfg), mesh)
        batch = {"tokens": ref[arch + "/tokens"]}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(ref[arch + "/frames"])
        lg, cache = api.make_prefill(cfg, tp=tp, cache_len=18, mesh=mesh)(
            params, batch)
        rels, toks = [rel(lg, ref[arch + "/logits0"])], []
        decode = api.make_decode_step(cfg, tp=tp, mesh=mesh)
        for t in range(2):
            toks.append(lg[:, :cfg.vocab_size].argmax(-1).tolist())
            lg, cache = decode(params, cache, {
                "tokens": torch.from_numpy(ref[f"{arch}/feed{t}"])})
            rels.append(rel(lg, ref[f"{arch}/logits{t + 1}"]))
        return {"rel": rels, "tokens": toks, "vocab": int(lg.shape[-1]),
                "cache": {k: list(v.shape) for k, v in cache.items()
                          if hasattr(v, "shape")}}

    def batch_of(cfg, rng):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
             for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            b["frames"] = torch.from_numpy((rng.standard_normal(
                (4, cfg.enc_frames, cfg.d_model)) * 0.1).astype(
                np.float32)).to(torch.bfloat16)
        return b

    def paths(t, pre=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from paths(v, pre + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from paths(v, pre + (i,))
        else:
            yield pre, t

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t)

    @contextlib.contextmanager
    def products(dtype):
        '''The model's products in ``dtype`` inside the block.'''
        prev, L.COMPUTE_DTYPE = L.COMPUTE_DTYPE, dtype
        try:
            yield
        finally:
            L.COMPUTE_DTYPE = prev

    def steps_of(mesh, arch, tp, batches):
        '''``make_train_step`` over ``batches`` on ``mesh`` and on one
        rank at the same tp from one init: [(loss, norm)] each, the
        largest param gap, whether the moments take the params'
        placements; the mesh's state.'''
        cfg = cfg_of(arch)
        alone = api.module_for(cfg).init_params(cfg, tp=tp, seed=0,
                                                dtype=torch.float32)
        params = api.shard_params(cfg, copy.deepcopy(alone), mesh)
        step1, opt = api.make_train_step(cfg, tp=tp)
        state1 = opt.init(alone)
        step, opt = api.make_train_step(cfg, tp=tp, mesh=mesh)
        state = opt.init(params)
        got, want = [], []
        for b in batches:
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

    def grad_errs(mesh, arch, tp, batch):
        '''One batch's gradients on ``mesh`` (``reduce_grads`` with the
        family's ``partial_grad``) against one rank's, leaf by leaf: the
        three worst [error, path].'''
        cfg = cfg_of(arch)
        mod = api.module_for(cfg)
        alone = mod.init_params(cfg, tp=tp, seed=0, dtype=torch.float32)
        params = api.shard_params(cfg, copy.deepcopy(alone), mesh)

        def loss(p, d):
            return mod.loss_fn(p, cfg, d, tp=tp), None
        _, want = value_and_grad(loss, alone, batch)
        with use_mesh(mesh):
            rows, _ = parallel.split_rows(batch, mesh, required=True)
            with C.batch_split():
                _, got = value_and_grad(loss, parallel.gather_params(params),
                                        rows)
            got = parallel.reduce_grads(got, params,
                                        api.partial_grad(cfg, tp))
        errs = [[float((whole(a) - b).abs().max()
                       / max(float(b.abs().max()), 1e-4)),
                 ".".join(map(str, path))]
                for (path, a), (_, b) in zip(paths(got), paths(want))]
        return sorted(errs, reverse=True)[:3]

    def training(mesh, arch, tp, steps=2):
        '''The mesh's train steps against one rank's: with float32
        products, the first batch's gradients leaf by leaf and ``steps``
        steps; with the served bf16 products, the first step.  The
        float32 state.'''
        cfg = cfg_of(arch)
        rng = np.random.default_rng(3)
        batches = [batch_of(cfg, rng) for _ in range(steps)]
        with products(torch.float32):
            errs = grad_errs(mesh, arch, tp, batches[0])
            f32, state = steps_of(mesh, arch, tp, batches)
        bf16, _ = steps_of(mesh, arch, tp, batches[:1])
        return {"grad_errs": errs, "f32": f32, "bf16": bf16}, state
""")

#: (1, 2): serving against the reference at tp 2; gradients and two train
#: steps; each trained state saved (whole leaves beside it); the serve
#: and train CLIs at --model-parallel 2 (the group is up, so they join it)
WORLD2 = PRELUDE + textwrap.dedent("""
    import contextlib, io
    from repro_torch.launch import serve, train
    from repro_torch.runtime import checkpoint
    ref = dict(np.load("ref2.npz"))
    mesh = mesh_of(1, 2)
    res = {}
    for arch in ARCHS:
        r = {"serving": serving(mesh, ref, arch, 2)}
        r["training"], state = training(mesh, arch, 2)
        checkpoint.save(f"ckpt-{arch}", 2, state)
        full = {str(i): whole(t).numpy() for i, t in enumerate(leaves(state))}
        if rank == 0:
            np.savez(f"saved-{arch}.npz", **full)
        res[arch] = r

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return json.loads(buf.getvalue().strip().splitlines()[-1])
    for arch in ARCHS:
        rep = run(serve.main, ["--arch", arch, "--reduced", "--device", "cpu",
                               "--model-parallel", "2", "--batch", "2",
                               "--prompt-len", "8", "--gen", "3"])
        res[arch]["serve_cli"] = {k: rep[k] for k in (
            "model_parallel", "devices", "sample", "family")}
        rep = run(train.main, ["--arch", arch, "--reduced", "--device", "cpu",
                               "--model-parallel", "2", "--steps", "2",
                               "--batch", "4", "--seq", "16"])
        res[arch]["train_cli"] = {k: rep[k] for k in (
            "model_parallel", "devices", "steps", "first_loss")}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")

#: (1, 4): serving against the reference at tp 4; each world-2 state
#: restored onto (1, 4) and (2, 2)
WORLD4 = PRELUDE + textwrap.dedent("""
    from repro_torch.optim.adam import AdamState
    from repro_torch.runtime import checkpoint
    ref = dict(np.load("ref4.npz"))
    res = {}
    for arch in ARCHS:
        cfg = cfg_of(arch)
        r = {"serving": serving(mesh_of(1, 4), ref, arch, 4)}
        saved = dict(np.load(f"saved-{arch}.npz"))
        like = api.abstract_params(cfg, 2)
        state = AdamState(torch.zeros((), dtype=torch.int32), like, like)
        for dp, mp in ((1, 4), (2, 2)):
            mesh = mesh_of(dp, mp)
            ps = api.param_shardings(cfg, like, mesh)
            (params, opt), _ = checkpoint.restore(
                f"ckpt-{arch}", 2, (like, state),
                shardings=(ps, AdamState(None, ps, ps)))
            r[f"restore_{dp}x{mp}"] = all(
                np.array_equal(whole(t).numpy(), saved[str(i)])
                for i, t in enumerate(leaves((params, opt))))
        res[arch] = r
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")

#: (2, 2): serving against the reference at tp 2; training; the
#: collectives of a prefill and a train step against the account
WORLD22 = PRELUDE + textwrap.dedent("""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.roofline.analyze import collective_account
    from repro_torch.sharding import AbstractMesh, Partitioner
    ref = dict(np.load("ref2.npz"))
    mesh = mesh_of(2, 2)
    KIND = {"all_reduce": "all-reduce", "reduce_scatter_tensor":
            "reduce-scatter", "all_gather_into_tensor": "all-gather"}

    def counted(cm):
        return {KIND[str(op).split(".")[-1].rstrip("')>")]: n
                for op, n in cm.get_comm_counts().items()}
    res = {}
    for arch in ARCHS:
        cfg = cfg_of(arch)
        mod = api.module_for(cfg)
        r = {"serving": serving(mesh, ref, arch, 2)}
        r["training"], _ = training(mesh, arch, 2)
        rng = np.random.default_rng(5)
        b = batch_of(cfg, rng)
        params = api.shard_params(cfg, mod.init_params(cfg, tp=2, seed=0),
                                  mesh)
        with CommDebugMode() as cm:
            api.make_prefill(cfg, tp=2, mesh=mesh)(
                params, {k: v for k, v in b.items() if k != "labels"})
        r["prefill_counts"] = counted(cm)
        params = api.shard_params(cfg, mod.init_params(
            cfg, tp=2, seed=0, dtype=torch.float32), mesh)
        step, opt = api.make_train_step(cfg, tp=2, mesh=mesh)
        state = opt.init(params)
        with CommDebugMode() as cm:
            step(params, state, b)
        r["train_counts"] = counted(cm)
        aparams = api.abstract_params(cfg, 2)
        shardings = Partitioner(AbstractMesh(("data", "model"), (2, 2))
                                ).tree_shardings(aparams, api.param_axes(cfg))
        for kind in ("prefill", "train"):
            acc = collective_account(cfg, ShapeConfig("c", 16, 4, kind),
                                     aparams, shardings, api.param_axes(cfg),
                                     rows_local=2)
            r[f"{kind}_account"] = acc.counts
        res[arch] = r
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")

#: (1, 3): the fallbacks: serving against the reference at tp 3
WORLD3 = PRELUDE + textwrap.dedent("""
    ref = dict(np.load("ref3.npz"))
    res = {arch: {"serving": serving(mesh_of(1, 3), ref, arch, 3)}
           for arch in ARCHS}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The spawns' shared directory, with the reference's arrays."""
    d = tmp_path_factory.mktemp("mesh_families")
    for tp in (2, 3, 4):
        np.savez(d / f"ref{tp}.npz", **_refs(tp))
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


# ---------------------------------------------------------------------------
# serving: the model functions against the reference at the mesh's tp
# ---------------------------------------------------------------------------

#: each arch's local cache shapes at (data, model) = (1, 2), (1, 4), (2, 2)
#: and (1, 3) for B = 4: mamba2's SSM heads and conv channels (its value
#: channels d_inner / n and all 32 B/C channels), recurrentgemma's RG-LRU
#: channels and KV heads (its one KV head repeated to tp), whisper's KV
#: heads of the self and cross caches
CACHES = {
    "mamba2-1.3b": {
        (1, 2): {"ssm": [2, 4, 4, 16, 16], "conv": [2, 4, 3, 96]},
        (1, 4): {"ssm": [2, 4, 2, 16, 16], "conv": [2, 4, 3, 64]},
        (2, 2): {"ssm": [2, 2, 4, 16, 16], "conv": [2, 2, 3, 96]},
        (1, 3): {"ssm": [2, 4, 8, 16, 16], "conv": [2, 4, 3, 160]}},
    "recurrentgemma-2b": {
        (1, 2): {"lru1": [1, 4, 32], "conv1": [1, 4, 3, 32],
                 "k": [1, 4, 8, 1, 16]},
        (1, 4): {"lru1": [1, 4, 16], "conv1": [1, 4, 3, 16],
                 "k": [1, 4, 8, 1, 16]},
        (2, 2): {"lru1": [1, 2, 32], "conv1": [1, 2, 3, 32],
                 "k": [1, 2, 8, 1, 16]},
        (1, 3): {"lru1": [1, 4, 64], "conv1": [1, 4, 3, 64],
                 "k": [1, 4, 8, 1, 16]}},
    "whisper-large-v3": {
        (1, 2): {"k": [2, 4, 18, 2, 16], "xk": [2, 4, 12, 2, 16]},
        (1, 4): {"k": [2, 4, 18, 1, 16], "xk": [2, 4, 12, 1, 16]},
        (2, 2): {"k": [2, 2, 18, 2, 16], "xk": [2, 2, 12, 2, 16]},
        (1, 3): {"k": [2, 4, 18, 2, 16], "xk": [2, 4, 12, 2, 16]}},
}


def _held_to_reference(outs, mesh):
    for arch in ARCHS:
        for out in outs:
            s = out[arch]["serving"]
            assert max(s["rel"]) < LOGITS_REL, (arch, s["rel"])
            assert s["vocab"] == 256
            for name, shape in CACHES[arch][mesh].items():
                assert s["cache"][name] == shape, (arch, name, s["cache"])
            assert s == outs[0][arch]["serving"]


def test_serving_on_1x2_matches_reference(world2):
    """(1, 2), tp 2: each family's prefill and two greedy decode steps
    within 0.05 of the reference's logits on every rank (all equal, the
    same greedy tokens); each rank's cache holds its share: mamba2's 4 of
    8 SSM heads and 64 + 32 convolution channels, recurrentgemma's 32 of
    64 RG-LRU channels and 1 of 2 KV heads, whisper's 2 of 4 KV heads in
    the self and the cross caches."""
    _held_to_reference(world2, (1, 2))


def test_serving_on_1x4_matches_reference(world4):
    """(1, 4), tp 4: within the gate; mamba2's 2 heads a rank (32 + 32
    convolution channels, where the partitioner's chunk of the 160 is 40),
    16 RG-LRU channels and one KV head a rank."""
    _held_to_reference(world4, (1, 4))


def test_serving_on_2x2_matches_reference(world22):
    """(2, 2): FSDP over "data" and tp 2; each rank's caches hold its 2
    of the 4 rows; the logits of every row on every rank."""
    _held_to_reference(world22, (2, 2))


def test_serving_on_1x3_with_the_fallbacks(world3):
    """(1, 3), tp 3: 3 divides neither mamba2's 8 heads and 160 channels
    nor recurrentgemma's width of 64 nor the vocabulary of 256 (all
    replicated: every rank runs those blocks whole); the attention heads
    (whisper's 4 padded to 6, recurrentgemma's 4 to 6 over 3 copies of
    its KV head) and the MLPs' 96 hidden units split."""
    _held_to_reference(world3, (1, 3))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_on_the_mesh_match_one_rank(arch, mesh, world2,
                                                world22):
    """The mesh's ``make_train_step`` against the one-rank port's at tp 2
    from one init.  With float32 products (the mesh then computes what
    one rank computes, to float32 rounding): each leaf's gradient of the
    first batch within 1e-4 of its largest value (``reduce_grads`` with
    the family's ``partial_grad``: mamba2's ``w_bc``, the attentions' K/V
    projections; a leaf whose partial gradient no rank sums is off by
    half), two steps' losses and grad norms within their bars and the
    params within 3 * lr * steps.  With the served bf16 products, the
    first step's loss and norm within the same bars.  (A second bf16 step
    is not held to them: Adam's first step moves each weight by about lr
    whatever its gradient's size, so the ranks' bf16 rounding flips the
    sign of the small gradients of recurrentgemma's tied table, whose
    second-step norm then moved by 1.6e-3 to 1.1e-2 against one rank's
    over 7 batches on (2, 2), and by 1.9e-4 to 2.4e-3 over the same
    batches on (2, 1), data parallelism alone.)  Every rank the same loss
    and norm; Adam's moments laid out as the params."""
    outs = world2 if mesh == "1x2" else world22
    for out in outs:
        tr = out[arch]["training"]
        assert tr["grad_errs"][0][0] <= GRAD_REL, tr["grad_errs"]
        for run in ("f32", "bf16"):
            r = tr[run]
            assert len(r["mesh"]) == (STEPS if run == "f32" else 1)
            for (loss, norm), (loss1, norm1) in zip(r["mesh"], r["alone"]):
                assert abs(loss - loss1) <= LOSS_REL * loss1, (run, r)
                assert abs(norm - norm1) <= NORM_REL * norm1, (run, r)
            assert r["param_gap"] <= 3 * LR * STEPS, r["param_gap"]
            assert r["moments_placed"]
        assert tr == outs[0][arch]["training"]


@pytest.mark.parametrize("arch", ARCHS)
def test_partial_grad_names_the_leaves_left_whole(arch):
    """The leaves ``reduce_grads`` sums over "model": mamba2's ``w_bc`` and
    convolution where the ranks run their heads (tp 2, 4; none at tp 3,
    where every rank runs the whole block), the attentions' K/V
    projections (and whisper's K/V biases) at every tp, nothing of the
    RG-LRU block."""
    cfg = get_arch(arch).reduced()
    got = {}
    for tp in (2, 3, 4):
        part = api.partial_grad(cfg, tp)
        got[tp] = sorted({".".join(str(p) for p in path if
                                   not isinstance(p, int))
                          for path in _paths(api.abstract_params(cfg, tp))
                          if part(path)})
    want = {
        "mamba2-1.3b": {2: ["layers.conv_b", "layers.conv_w",
                            "layers.w_bc"], 3: [],
                        4: ["layers.conv_b", "layers.conv_w",
                            "layers.w_bc"]},
        "recurrentgemma-2b": {tp: ["super.attn.attn.wk", "super.attn.attn.wv"]
                              for tp in (2, 3, 4)},
        "whisper-large-v3": {tp: sorted(
            f"{s}.{a}.{w}" for s, a in (("enc_layers", "attn"),
                                        ("dec_layers", "self_attn"),
                                        ("dec_layers", "cross_attn"))
            for w in ("bk", "bv", "wk", "wv")) for tp in (2, 3, 4)},
    }[arch]
    assert got == want


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, pre + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, pre + (i,))
    else:
        yield pre


# ---------------------------------------------------------------------------
# sharded restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_state_saved_at_world2_restores_at_world4_and_world1(arch, world2,
                                                             world4, work):
    """Each family's trained state (params and Adam's moments) saved at
    world 2 restores with equal leaves onto (1, 4) and (2, 2) DTensors
    (mamba2's convolution leaves split 40 a rank, then 80) and at world 1
    as whole tensors."""
    for out in world4:
        assert out[arch]["restore_1x4"] and out[arch]["restore_2x2"]
    cfg = get_arch(arch).reduced()
    like = api.abstract_params(cfg, 2)
    state = AdamState(torch.zeros((), dtype=torch.int32), like, like)
    tree, _ = checkpoint.restore(work / f"ckpt-{arch}", 2, (like, state))
    saved = np.load(work / f"saved-{arch}.npz")
    for i, t in enumerate(leaves(tree)):
        np.testing.assert_array_equal(t.numpy(), saved[str(i)])


# ---------------------------------------------------------------------------
# the collective account
# ---------------------------------------------------------------------------

#: CommDebugMode's counts of one prefill (4 x 16 tokens) and one train
#: step on (2, 2), kind by kind
COUNTS = {
    "mamba2-1.3b": ({"all-gather": 15, "all-reduce": 5},
                    {"all-gather": 16, "reduce-scatter": 13,
                     "all-reduce": 34}),
    "recurrentgemma-2b": ({"all-gather": 24, "all-reduce": 7},
                          {"all-gather": 25, "reduce-scatter": 22,
                           "all-reduce": 46}),
    "whisper-large-v3": ({"all-gather": 35, "all-reduce": 11},
                         {"all-gather": 34, "reduce-scatter": 33,
                          "all-reduce": 116}),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_comm_counts_on_2x2_equal_the_account(arch, world22):
    """``CommDebugMode`` over one prefill and one train step on (2, 2)
    counts, kind by kind, what ``collective_account`` prices: besides the
    transformer's terms, mamba2's convolution taps gathered a layer (a
    reduce-scatter of their gradient backward) and ``out_norm``'s sums of
    squares all-reduced forward and backward, the RG-LRU gates' gather of
    the convolution's output (likewise), whisper's encoder states' f at
    the cross K/V projections; every forward collective of a layer again
    under remat."""
    prefill, train = COUNTS[arch]
    for out in world22:
        r = out[arch]
        assert r["prefill_counts"] == r["prefill_account"] == prefill
        assert r["train_counts"] == r["train_account"] == train


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _cli_alone(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_with_model_parallel_over_two_ranks(arch, world2):
    """Under a process group of 2 ranks ``launch/serve.py
    --model-parallel 2`` serves each family at tp 2 over 2 devices, every
    rank the same tokens; mamba2's equal to one process's (its layout at
    tp 2 is tp 1's: the params drawn alike); ``launch/train.py
    --model-parallel 2`` trains 2 steps at tp 2."""
    for out in world2:
        rep = out[arch]["serve_cli"]
        assert (rep["model_parallel"], rep["devices"]) == (2, 2)
        assert rep == world2[0][arch]["serve_cli"]
        tr = out[arch]["train_cli"]
        assert (tr["model_parallel"], tr["devices"], tr["steps"]) == (2, 2, 2)
        assert np.isfinite(tr["first_loss"])
    if arch == "mamba2-1.3b":
        alone = _cli_alone(serve.main, [
            "--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "3"])
        assert alone["model_parallel"] == 1
        assert world2[0][arch]["serve_cli"]["sample"] == alone["sample"]
