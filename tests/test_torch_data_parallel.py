"""Data-parallel DWN serving and training over ``torch.distributed``
(gloo, on the CPU), the twins of the reference's ``shard_map`` paths
over its ``("data",)`` mesh (``tests/test_serving.py::
test_engine_data_parallel_shard_map``, ``tests/test_training.py::
test_train_dwn_batch_shard_map_data_parallel``).

Each test starts its ranks as processes of their own (one torch thread
each), joined by a ``file://`` rendezvous in the test's temporary
directory, under a timeout; each rank writes its result as JSON."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240

PRELUDE = textwrap.dedent("""
    import faulthandler, json, sys
    import torch
    import torch.distributed as dist
    faulthandler.enable()   # a fatal signal prints every thread's stack
    torch.set_num_threads(1)
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + init,
                            world_size=world, rank=rank)
""")

#: every rank's last lines, after its result is written and its group
#: destroyed: leave without the interpreter's C++ teardown, in which gloo
#: aborts the process now and then ("terminate called without an active
#: exception") after all its work, also in a script of torch.distributed
#: alone that imports nothing of the port
EXIT = textwrap.dedent("""
    import os, sys
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
""")

SERVE = PRELUDE + textwrap.dedent("""
    import numpy as np
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.core.model import apply_hard
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding import Partitioner, hint, use_mesh

    eng = ServingEngine("dwn-jsc-sm", max_bucket=64, min_bucket=1,
                        n_train=800, backend="packed-xla", device="cpu")
    sharded = []
    dp_step = eng._dp_step
    eng._dp_step = lambda b, x: (sharded.append(int(x.shape[0])),
                                 dp_step(b, x))[1]
    for n in (64, 17, 40, 8):
        eng.submit(eng.make_request(n, seed=n))
    done = eng.drain()
    served = eng.report()["served"]
    eng.submit(eng.make_request(1, seed=1))          # bucket 1: unsharded
    done += eng.drain()
    oracle = eng.backends["float-oracle"]
    exact = True
    for r in done:
        x = torch.from_numpy(np.asarray(r.payload, np.float32))
        counts, pred = (a.numpy() for a in oracle.step_for(x.shape[0])(x))
        exact &= np.array_equal(np.asarray(r.result[0]), counts)
        exact &= np.array_equal(np.asarray(r.result[1]), pred)
        exact &= np.array_equal(np.asarray(r.result[0]),
                                apply_hard(eng.artifact.frozen, x).numpy())
    rep = eng.report()
    # a continuous session: rank 0 leads (its requests, its buckets),
    # the other ranks follow
    async_exact = None
    with eng.serve():
        if eng.continuous_loop == "leader":
            reqs = [eng.submit_async(r.payload) for r in done]
            async_exact = all(
                f.future.result().ok and all(
                    np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(f.future.result().value, r.result))
                for f, r in zip(reqs, done))
    cont = {"loop": eng.report()["continuous_loop"], "exact": async_exact}
    # the DTensor side of the partitioner and of hint()
    mesh = make_data_mesh(device_type="cpu")
    part = Partitioner(mesh)
    spec = part.spec(("dwn_batch", None), (4, 2))
    t = distribute_tensor(torch.arange(8.0).reshape(4, 2), mesh,
                          [Replicate()])
    with use_mesh(mesh):
        h = hint(t, "dp", None)
        plain = torch.ones(3)
        same = hint(plain, "dp") is plain
    json.dump({"devices": rep["devices"], "dp": rep["data_parallel"],
               "exact": bool(exact), "served": served,
               "served_all": rep["served"], "sharded": sharded,
               "startup_check": rep["bit_exact_vs_oracle"],
               "continuous": cont,
               "placements": [repr(p) for p in part.placements(spec)],
               "hinted": [repr(p) for p in h.placements],
               "hinted_full": h.full_tensor().tolist(),
               "plain_passes": same}, open(out, "w"))
    dist.destroy_process_group()
""") + EXIT

TRAIN = PRELUDE + textwrap.dedent("""
    from repro_torch.core.model import JSC_PRESETS
    from repro_torch.data.jsc import load_jsc
    from repro_torch.training.batch import train_dwn_batch

    data = load_jsc(1000, 200, seed=0)
    out_ = train_dwn_batch(JSC_PRESETS["sm-10"], data, epochs=2,
                           seeds=range(4), data_parallel=True, device="cpu")
    json.dump({"dp": out_.data_parallel,
               "losses": [[h["loss"] for h in r.history]
                          for r in out_.results],
               "acc": [r.soft_test_acc for r in out_.results],
               "tables": [r.params["layers"][0]["tables"].tolist()
                          for r in out_.results]}, open(out, "w"))
    dist.destroy_process_group()
""") + EXIT

# no init here: the CLI joins the group from the environment, as under
# torchrun
CLI = textwrap.dedent("""
    import contextlib, io, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch import serve
    torch.set_num_threads(1)
    out = sys.argv[4]
    reports = []
    for extra in ([], ["--no-data-parallel"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", "dwn-jsc-sm", "--reduced", "--device",
                        "cpu", "--requests", "3", "--batch", "32",
                        "--ragged"] + extra)
        reports.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    json.dump([{k: r[k] for k in ("data_parallel", "devices", "served",
                                  "bit_exact_vs_oracle", "sample")}
               for r in reports], open(out, "w"))
    dist.destroy_process_group()
""") + EXIT


#: the continuous loop on a data-parallel engine: a served session (a
#: ragged stream, oversize requests included) against apply_hard and
#: the one-rank loop's; the leader's buckets on an injected clock
#: against the one-rank loop's; a session that sheds at admission; two
#: sessions whose step fails, on the leader and on the last rank
CONT = PRELUDE + textwrap.dedent("""
    import threading
    import numpy as np
    from repro_torch.core.model import apply_hard
    from repro_torch.serving import ServingEngine, SLOConfig
    from repro_torch.serving.backends import StepTimeEstimator

    def make(dp):
        return ServingEngine("dwn-jsc-sm", max_bucket=64, min_bucket=1,
                             n_train=800, backend="packed-xla",
                             device="cpu", data_parallel=dp)
    eng, alone = make(True), make(False)
    loop = eng.continuous_loop
    rng = np.random.default_rng(11)
    stream = [eng.make_request(int(n), seed=i)
              for i, n in enumerate(rng.integers(1, 150, 24))]

    def session(engine):
        # the stream through a continuous session of engine: its results
        # (None on a follower)
        with engine.serve():
            if engine.continuous_loop == "follower":
                return None
            reqs = [engine.submit_async(p) for p in stream]
            return [r.future.result() for r in reqs]

    def values(results):
        return [[np.asarray(a).tolist() for a in r.value] for r in results]
    res = {"loop": loop}
    got = session(eng)
    if loop == "leader":
        want = session(alone)
        res["all_ok"] = all(r.ok for r in got)
        res["equal_alone"] = values(got) == values(want)
        res["equal_apply_hard"] = all(
            np.array_equal(np.asarray(r.value[0]), apply_hard(
                eng.artifact.frozen,
                torch.from_numpy(np.asarray(p, np.float32))).numpy())
            for r, p in zip(got, stream))
    res["report_loop"] = eng.report()["continuous_loop"]

    def formed(engine):
        # the same submits and steps on an injected clock (1 ms a
        # reading), some with deadlines: samples launched a step, each
        # request's buckets and shed reason
        t = [0.0]

        def clock():
            t[0] += 1e-3
            return t[0]
        engine.estimator = StepTimeEstimator()
        engine.estimator.seed(64, 4e-3)
        cont = engine._continuous(SLOConfig(max_queue_samples=10**6),
                                  timer=clock)
        steps = []
        for i, p in enumerate(stream):
            cont.submit(p, deadline_ms=(6.0 if i % 4 == 1 else None))
            if i % 3 == 2:
                steps.append(cont.step_once())
        while cont.pending:
            steps.append(cont.step_once())
        return steps, [[r.rid, list(r.buckets), r.shed]
                       for r in cont.completed]
    if loop == "leader":
        res["formed"] = formed(eng)
        eng._send_stop()
        res["formed_alone"] = formed(alone)
    else:
        res["followed"] = eng._follow() is None

    # deadlines no step can meet: shed at admission; the session ends on
    # every rank
    with eng.serve():
        if loop == "leader":
            shed = [eng.submit_async(p, deadline_ms=1e-6) for p in stream]
            res["shed"] = sorted({r.future.result().shed for r in shed})

    # a step that fails on rank bad: the leader's future fails, every
    # rank's session ends and raises at its stop.  The fault is in place
    # before the session starts, so that no bucket of the session can run
    # on rank bad ahead of it (a follower's loop thread takes the leader's
    # buckets as soon as serve() has started it).  start_serving steps
    # every bucket on the calling thread first, and on every rank, so the
    # fault fails only the steps of the session's loop threads
    ok_step = eng.backend.step_for
    main = threading.main_thread()
    warm = []

    def failing(k):
        if threading.current_thread() is main:
            warm.append(k)
            return ok_step(k)
        raise RuntimeError("injected")
    for bad in (0, world - 1):
        ended = None
        warm.clear()
        if rank == bad:
            eng.backend.step_for = failing
        try:
            with eng.serve():
                if loop == "leader":
                    f = eng.submit_async(stream[0][:64]).future
                    try:
                        f.result(timeout=60)
                        ended = "served"
                    except Exception as exc:
                        ended = type(exc).__name__
        except RuntimeError as exc:
            res[f"stop_raised_{bad}"] = type(exc.__cause__).__name__
        eng.backend.step_for = ok_step
        res[f"future_{bad}"] = ended
        if rank == bad:
            res[f"warm_{bad}"] = len(warm)
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""") + EXIT

CLI_CONTINUOUS = textwrap.dedent("""
    import contextlib, io, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch import serve
    torch.set_num_threads(1)
    out = sys.argv[4]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "dwn-jsc-sm", "--reduced", "--device", "cpu",
                    "--requests", "5", "--batch", "32", "--ragged",
                    "--continuous"])
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    json.dump({k: rep.get(k) for k in (
        "continuous_loop", "data_parallel", "devices", "served", "sample",
        "bit_exact_vs_oracle")}, open(out, "w"))
    dist.destroy_process_group()
""") + EXIT


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(script: str, world: int, tmp_path: Path, *,
           launcher_env: bool = False) -> list[dict]:
    """Run ``script`` on ``world`` gloo ranks; each rank's JSON result.
    ``launcher_env``: also give each rank the variables torchrun sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_AUTOTUNE="0")
    if launcher_env:
        env.update(WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()))
    init = tmp_path / "rendezvous"
    outs = [tmp_path / f"rank{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(init),
         str(outs[r])], env=dict(env, RANK=str(r)), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
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
    for r, err in enumerate(errs):
        (tmp_path / f"rank{r}.err").write_text(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(o.read_text()) for o in outs]


@pytest.mark.parametrize("world", [2, 4])
def test_engine_data_parallel_over_gloo(world, tmp_path):
    """Exact: every rank serves the 64 + 17 + 40 + 8 rows equal to the
    float oracle and ``apply_hard``, reporting ``devices == world`` and
    ``data_parallel``; the buckets the ranks divide (64, 8 among them)
    are split, the 1-row bucket runs whole on every rank; a continuous
    session serves the same requests again, rank 0 leading and the other
    ranks following, its results equal to the drain's; on the
    ``("data",)`` DeviceMesh the batch spec is ``Shard(0)`` and ``hint``
    redistributes a replicated DTensor to it, passing plain tensors
    through."""
    for rank, out in enumerate(_spawn(SERVE, world, tmp_path)):
        assert out["devices"] == world and out["dp"] is True
        assert out["exact"] is True
        assert out["served"] == 64 + 17 + 40 + 8
        assert out["served_all"] == 64 + 17 + 40 + 8 + 1
        assert 8 in out["sharded"] and 64 in out["sharded"]
        assert 1 not in out["sharded"]
        assert all(b % world == 0 for b in out["sharded"])
        assert out["startup_check"] == {"fused-packed": True,
                                        "packed-eager": True}
        assert out["continuous"] == (
            {"loop": "leader", "exact": True} if rank == 0
            else {"loop": "follower", "exact": None})
        assert out["placements"] == ["Shard(dim=0)"]
        assert out["hinted"] == ["Shard(dim=0)"]
        assert out["hinted_full"] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0],
                                      [6.0, 7.0]]
        assert out["plain_passes"] is True


def test_train_dwn_batch_data_parallel_over_gloo(tmp_path):
    """Two ranks train four seeds, two each; every rank ends with all
    four members in seed order, each member's loss history within 1e-6
    of the same seed trained alone in one process (its accuracy and
    tables equal), with ``data_parallel`` True."""
    from repro_torch.core.model import JSC_PRESETS
    from repro_torch.data.jsc import load_jsc
    from repro_torch.training.batch import train_dwn_batch
    outs = _spawn(TRAIN, 2, tmp_path)
    data = load_jsc(1000, 200, seed=0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alone = [train_dwn_batch(JSC_PRESETS["sm-10"], data, epochs=2,
                                 seeds=(s,), device="cpu").results[0]
                 for s in range(4)]
    finally:
        torch.set_num_threads(n)
    for out in outs:
        assert out["dp"] is True and len(out["losses"]) == 4
        for s, r in enumerate(alone):
            want = [h["loss"] for h in r.history]
            np.testing.assert_allclose(out["losses"][s], want, rtol=0,
                                       atol=1e-6)
            assert abs(out["acc"][s] - r.soft_test_acc) < 1e-6
            np.testing.assert_array_equal(
                np.asarray(out["tables"][s]),
                r.params["layers"][0]["tables"].numpy())
    assert outs[0] == outs[1]
    assert len({round(l[-1], 6) for l in outs[0]["losses"]}) == 4


def test_serve_cli_passes_data_parallel_through(tmp_path):
    """``launch.serve`` on 2 ranks started as torchrun starts them: the
    CLI joins the gloo group from the environment; data parallel by
    default (``devices`` 2), alone on each rank with
    ``--no-data-parallel`` (``devices`` still 2, as the reference reports
    the mesh); both serve the same rows bit-exact, on both ranks
    alike."""
    outs = _spawn(CLI, 2, tmp_path, launcher_env=True)
    assert outs[0] == outs[1]
    dp, alone = outs[0]
    assert (dp["data_parallel"], dp["devices"]) == (True, 2)
    assert (alone["data_parallel"], alone["devices"]) == (False, 2)
    assert dp["served"] == alone["served"] and dp["sample"] == \
        alone["sample"]
    assert all(dp["bit_exact_vs_oracle"].values())


_CONT = {}


@pytest.fixture(params=[2, 4])
def continuous(request, tmp_path_factory):
    """The CONT spawn's per-rank results on 2 or 4 ranks (one spawn a
    world for the tests below)."""
    world = request.param
    if world not in _CONT:
        _CONT[world] = _spawn(CONT, world,
                              tmp_path_factory.mktemp(f"cont{world}"))
    return _CONT[world]


def test_continuous_loop_on_a_data_parallel_engine(continuous):
    """Exact: a ragged stream of 24 requests of 1-149 rows (oversize ones
    in 64-row chunks) through a continuous session of a data-parallel
    engine: rank 0 leads, every other rank follows; every result is ok
    and equal to ``apply_hard`` and to the one-rank loop's."""
    lead, *follow = continuous
    assert (lead["loop"], lead["report_loop"]) == ("leader", "leader")
    assert lead["all_ok"] and lead["equal_apply_hard"]
    assert lead["equal_alone"]
    for out in follow:
        assert (out["loop"], out["report_loop"]) == ("follower",
                                                      "follower")


def test_continuous_leader_forms_the_one_rank_loops_buckets(continuous):
    """On an injected clock the leader's scheduler forms the one-rank
    loop's buckets step by step (samples launched a step; each request's
    buckets and shed reason, some expired at their 6 ms deadline) while
    the followers run them, until its stop."""
    lead, *follow = continuous
    steps, reqs = lead["formed"]
    assert [steps, reqs] == lead["formed_alone"]
    assert any(shed == "expired" for _, _, shed in reqs)
    assert all(out["followed"] for out in follow)


def test_continuous_sessions_with_sheds_and_a_failing_step_end(continuous):
    """A session whose deadlines no step meets sheds every request at
    admission and ends on every rank; a step that fails on the leader, or
    on the last rank only, fails the leader's future with
    ``DataParallelStepError`` and ends the session on every rank, each
    rank's stop raising it (no rank waits on a collective another has
    left)."""
    lead = continuous[0]
    assert lead["shed"] == ["admission"]
    for bad in (0, len(continuous) - 1):
        assert lead[f"future_{bad}"] == "DataParallelStepError"
        # the fault was in place before the session: start_serving's
        # steps ran through it on the calling thread
        assert continuous[bad][f"warm_{bad}"] > 0
        for out in continuous:
            assert out[f"stop_raised_{bad}"] == "DataParallelStepError"


def test_serve_cli_continuous_over_two_ranks(tmp_path):
    """``launch.serve --continuous`` on 2 ranks as torchrun starts them:
    data parallel (``devices`` 2); rank 0 leads and reports the served
    requests, bit-exact at startup; rank 1 follows until rank 0 stops."""
    lead, follow = _spawn(CLI_CONTINUOUS, 2, tmp_path, launcher_env=True)
    assert (lead["continuous_loop"], follow["continuous_loop"]) == (
        "leader", "follower")
    assert lead["data_parallel"] and lead["devices"] == 2
    assert lead["served"] > 0 and lead["sample"]
    assert all(lead["bit_exact_vs_oracle"].values())
    assert follow["served"] == 0
