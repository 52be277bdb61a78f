"""The serving slice as a whole: a model the reference built, served by the
reference's engine and by the port's engine on the same request stream.

The reference fits ``dwn-jsc-sm`` and ``dwn-jsc-lg`` (its own ``jax.random``
init); the parameters cross to the port as numpy.  Per-request counts and
predictions must be identical (exact: integers), and the port's startup
``verify_backends`` must pass.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.dwn import DWNArtifact as JArtifact  # noqa: E402
from repro.dwn import get_spec as jget_spec  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.workloads import load_workload  # noqa: E402
from repro_torch.core.model import params_from_numpy  # noqa: E402
from repro_torch.dwn import DWNArtifact, DWNSpec, get_spec  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import backends as tb  # noqa: E402

N_TRAIN = 1200
# ragged sizes incl. one larger than max_bucket (split into chunks)
SIZES = (5, 32, 40, 1, 17, 9)


def _reference_artifact(name, frac=False):
    spec = jget_spec(name)
    data = load_workload(spec.workload, N_TRAIN, 512, seed=0)
    return JArtifact(spec).fit(data.x_train, seed=0)


def _port_artifact(name, jart):
    params, buffers = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jart.params),
        {"thresholds": np.asarray(jart.buffers["thresholds"])})
    return DWNArtifact(get_spec(name)).adopt(params, buffers)


@pytest.mark.parametrize("name", ["dwn-jsc-sm", "dwn-jsc-lg"])
def test_port_serves_reference_model_identically(name):
    """Exact: per-request counts and predictions of the two engines."""
    jart = _reference_artifact(name)
    jeng = JEngine(jart, max_bucket=32, min_bucket=8, n_train=N_TRAIN,
                   seed=0)
    teng = ServingEngine(_port_artifact(name, jart), max_bucket=32,
                         min_bucket=8, n_train=N_TRAIN, seed=0,
                         device="cpu")
    assert teng.bit_exact == {"fused-packed": True, "packed-eager": True}
    assert teng.backend.name == "fused-packed"
    for a, b in zip(teng.artifact.frozen.mapping_idx,
                    jart.frozen.mapping_idx):
        np.testing.assert_array_equal(a, b)
    for i, size in enumerate(SIZES):
        payload = teng.make_request(size, seed=i)
        np.testing.assert_array_equal(payload,
                                      jeng.make_request(size, seed=i))
        jeng.submit(payload)
        teng.submit(payload)
    jdone = sorted(jeng.drain(), key=lambda r: r.rid)
    tdone = sorted(teng.drain(), key=lambda r: r.rid)
    assert [r.size for r in tdone] == list(SIZES)
    for j, t in zip(jdone, tdone):
        np.testing.assert_array_equal(t.result[0], np.asarray(j.result[0]))
        np.testing.assert_array_equal(t.result[1], np.asarray(j.result[1]))
        assert t.buckets == j.buckets
    rep = teng.report()
    assert rep["served"] == sum(SIZES) and rep["device"] == "cpu"
    assert rep["spec_fingerprint"] == jart.spec.fingerprint()


def test_batch_major_config_per_bucket_and_pen():
    """Exact: a PEN spec, served with ``tuned_configs`` naming the
    batch-major variant for some buckets, equals the float oracle."""
    spec = DWNSpec(preset="sm-50", variant="PEN", input_bits=9)
    eng = ServingEngine(spec, max_bucket=64, n_train=N_TRAIN, device="cpu")
    from repro_torch.kernels.autotune import FusedConfig
    eng.model.tuned_configs[16] = FusedConfig("batch-major", block_b=4)
    oracle = eng.backends["float-oracle"]
    for size in (3, 16, 64, 100):
        x = eng.make_request(size, seed=size)
        eng.submit(x)
    for r in eng.drain():
        c, p = oracle(torch.from_numpy(np.ascontiguousarray(r.payload)))
        np.testing.assert_array_equal(r.result[0], c.numpy())
        np.testing.assert_array_equal(r.result[1], p.numpy())
    assert eng.report()["tuned_configs"][16]["variant"] == "batch-major"


def test_verify_backends_refuses_a_broken_datapath():
    """A backend that differs from the oracle makes startup raise."""
    eng = ServingEngine("dwn-jsc-sm", max_bucket=16, n_train=N_TRAIN,
                        device="cpu")

    class Broken(tb.Backend):
        name = "broken"

        def make_step(self, model):
            def fn(x):
                counts = torch.zeros((x.shape[0], 5))
                return counts, counts.argmax(-1)
            return fn
    bound = tb.BoundBackend(Broken(), eng.model)
    with pytest.raises(RuntimeError, match="diverged"):
        tb.verify_backends(eng.model, [bound],
                           eng.data.x_test[:16])


def test_specs_match_reference():
    """Exact: the presets, to_dict and fingerprints of the same specs;
    invalid specs raise."""
    for name in ("dwn-jsc-sm", "dwn-jsc-md", "dwn-jsc-lg"):
        assert get_spec(name).to_dict() == jget_spec(name).to_dict()
        assert get_spec(name).fingerprint() == jget_spec(name).fingerprint()
    from repro.dwn import DWNSpec as JSpec
    pen = dict(preset="md-360", variant="PEN", input_bits=9, bits=64,
               placement="gaussian")
    assert DWNSpec(**pen).fingerprint() == JSpec(**pen).fingerprint()
    assert DWNSpec(**pen).dwn_config() == \
        DWNSpec.from_dict(DWNSpec(**pen).to_dict()).dwn_config()
    with pytest.raises(ValueError, match="requires input_bits"):
        DWNSpec(preset="sm-50", variant="PEN")
    with pytest.raises(ValueError, match="unregistered serving datapath"):
        DWNSpec(preset="sm-50", datapath="packed-xla-v2")


def test_every_reference_jsc_dwn_name_resolves_to_its_fingerprint():
    """Exact: each of the reference's 22 JSC DWN names (its spec presets
    and its other arch names), its 6 MNIST names
    (``dwn-mnist-{sm,md,lg}[-xla]``) and ``dwn-lm-head`` resolves in the
    port to the spec the reference resolves it to, ``to_dict`` and
    fingerprint included (13 distinct for JSC, 6 for MNIST, the LM head's
    with its workload and backbone); the port's spec presets are the
    reference's, and no DWN name is left unported."""
    from repro.configs.registry import get_arch, list_archs
    from repro.dwn import resolve_spec as jresolve
    from repro.dwn import spec_presets as jpresets
    from repro_torch.dwn import dwn_names, resolve_spec, spec_presets
    from repro_torch.dwn.spec import NOT_PORTED
    dwn = [n for n in list_archs() if get_arch(n).family == "dwn"]
    jsc = [n for n in dwn if jresolve(n).workload == "jsc"]
    mnist = [n for n in dwn if jresolve(n).workload == "mnist"]
    assert len(jsc) == 22 and len(mnist) == 6
    assert set(dwn) - set(jsc) - set(mnist) == {"dwn-lm-head"}
    assert sorted(dwn) == dwn_names()
    for names, distinct in ((jsc, 13), (mnist, 6), (["dwn-lm-head"], 1)):
        fps = set()
        for name in names:
            got, want = resolve_spec(name), jresolve(name)
            assert got.to_dict() == want.to_dict(), name
            assert got.fingerprint() == want.fingerprint(), name
            fps.add(got.fingerprint())
        assert len(fps) == distinct
    assert resolve_spec("dwn-jsc-sm-gaussian").fingerprint() == \
        "ded3a7ca71a42478"
    assert resolve_spec("dwn-jsc-lg-xla").fingerprint() == "244cf67cce326ab0"
    assert resolve_spec("dwn-mnist-lg").fingerprint() == "effa26c02e9a97b2"
    assert spec_presets() == sorted(jpresets())
    head = resolve_spec("dwn-lm-head")
    assert head.fingerprint() == "45d5bf86faeb3b92"
    assert (head.workload, head.backbone, head.effective_backbone,
            head.luts) == ("lm-head", "qwen3-8b", "qwen3-8b", 50)
    assert NOT_PORTED == {}


def test_serve_cli_resolves_a_placement_preset_on_cpu(capsys):
    """Exact: ``--arch dwn-jsc-sm-gaussian`` serves bit-exact against the
    oracle, with gaussian thresholds as the reference fits them."""
    from repro.core.thermometer import ThermometerSpec, fit_thresholds
    from repro_torch.launch import serve
    assert serve.main(["--arch", "dwn-jsc-sm-gaussian", "--reduced",
                       "--requests", "2", "--batch", "64", "--device",
                       "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["bit_exact_vs_oracle"] == {"fused-packed": True,
                                          "packed-eager": True}
    engine = ServingEngine("dwn-jsc-sm-gaussian", device="cpu",
                           max_bucket=64)
    x = load_workload("jsc", 2000, 512, seed=0).x_train
    np.testing.assert_array_equal(
        np.asarray(engine.artifact.frozen.thresholds),
        fit_thresholds(x, ThermometerSpec(16, 200, "gaussian")))


def test_serve_cli_on_cpu(capsys):
    """The CLI serves a ragged reduced stream and prints one JSON report."""
    import json
    from repro_torch.launch import serve
    assert serve.main(["--arch", "dwn-jsc-sm", "--reduced", "--ragged",
                       "--requests", "3", "--batch", "40", "--device",
                       "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["requests"] == 3 and rep["ragged"] is True
    assert rep["bit_exact_vs_oracle"] == {"fused-packed": True,
                                          "packed-eager": True}


# the datapath names the reference's DWNSpec accepts (its registered
# backends and "auto"), on lg-2400 TEN and an sm-50 PEN spec
DATAPATHS = ("auto", "packed-xla", "fused-packed")
SPECS = (dict(preset="lg-2400"),
         dict(preset="sm-50", variant="PEN", input_bits=9))


@pytest.mark.parametrize("datapath", DATAPATHS)
@pytest.mark.parametrize("spec_kw", SPECS, ids=["lg-TEN", "sm-PEN"])
def test_spec_datapaths_match_reference_and_serve(spec_kw, datapath,
                                                  tmp_path, monkeypatch):
    """Every datapath the reference's DWNSpec accepts is accepted with the
    reference's fingerprint (the name is kept as given), and the engine
    serves it on the CPU bit-exact to the oracle: ``packed-xla`` on the
    port's ``packed-eager``, ``auto`` per bucket."""
    from repro.dwn import DWNSpec as JSpec
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    spec = DWNSpec(datapath=datapath, **spec_kw)
    jspec = JSpec(datapath=datapath, **spec_kw)
    assert spec.to_dict() == jspec.to_dict()
    assert spec.fingerprint() == jspec.fingerprint()
    eng = ServingEngine(spec, max_bucket=16, min_bucket=8, n_train=600,
                        device="cpu")
    want = {"auto": "auto", "packed-xla": "packed-eager",
            "fused-packed": "fused-packed"}[datapath]
    assert eng.report()["datapath"] == want
    oracle = eng.backends["float-oracle"]
    for size in (16, 5):
        eng.submit(eng.make_request(size, seed=size))
    for r in eng.drain():
        c, p = oracle(torch.from_numpy(np.ascontiguousarray(r.payload)))
        np.testing.assert_array_equal(r.result[0], c.numpy())
        np.testing.assert_array_equal(r.result[1], p.numpy())


def test_backend_auto_calibrates_and_serves(tmp_path, monkeypatch):
    """backend="auto" (twin of the reference's
    ``test_backend_auto_select_calibrates_and_serves``): startup tunes the
    fused kernel at every bucket and times every bit-exact backend there,
    each bucket serves on the measured winner (near-ties toward the fused
    kernels), results stay exact, and ``use_backend`` round-trips to the
    saved calibration."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    eng = ServingEngine("dwn-jsc-sm", max_bucket=32, min_bucket=8,
                        n_train=800, backend="auto", device="cpu")
    assert eng.auto is not None
    assert sorted(eng.auto.choice) == list(eng.scheduler.buckets)
    assert sorted(eng.auto.timings[32]) == tb.available_backends()
    times = eng.auto.timings[32]
    fastest = min(times, key=times.get)
    chosen = eng.auto.choice[32]
    assert (chosen == fastest
            or (chosen == eng.auto.TIE_BREAK_BACKEND
                and times[chosen] <= times[fastest]
                * (1 + eng.auto.tie_break_pct / 100)))
    for n in (32, 5, 17, 32):
        eng.submit(eng.make_request(n, seed=n))
    done = eng.drain()
    assert sum(r.size for r in done) == 32 + 5 + 17 + 32
    oracle = eng.backends["float-oracle"]
    for r in done:
        c, p = oracle(torch.from_numpy(np.ascontiguousarray(r.payload)))
        np.testing.assert_array_equal(r.result[0], c.numpy())
        np.testing.assert_array_equal(r.result[1], p.numpy())
    rep = eng.report()
    assert rep["datapath"] == "auto" and rep["auto"]["choice"]
    assert sorted(eng.tuned_configs) == list(eng.scheduler.buckets)
    assert set(rep["tuned_configs"]) == set(eng.scheduler.buckets)
    for cfg in rep["tuned_configs"].values():
        assert cfg["variant"] in ("packed", "batch-major")
    assert rep["cuda_graphs"] == dict.fromkeys(tb.available_backends(),
                                               False)
    # the tuner wrote every bucket to the cache; a second engine reads it
    entries = json.loads((tmp_path / "c.json").read_text())["entries"]
    assert len(entries) == len(eng.scheduler.buckets)
    auto_before = eng.auto
    eng.use_backend("packed-xla")
    assert eng.auto is None and eng.backend.name == "packed-eager"
    eng.use_backend("auto")
    assert eng.auto is auto_before
    with pytest.raises(ValueError, match="unknown serving backend"):
        eng.use_backend("nope")


def test_autotune_off_by_environment(tmp_path, monkeypatch):
    """``REPRO_AUTOTUNE=0`` turns the startup tuning off, also for
    ``backend="auto"``; ``autotune=True`` tunes a pinned backend."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    eng = ServingEngine("dwn-jsc-sm", max_bucket=16, n_train=600,
                        autotune=True, device="cpu")
    assert sorted(eng.tuned_configs) == list(eng.scheduler.buckets)
    assert eng.backend.name == "fused-packed" and eng.auto is None
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    eng = ServingEngine("dwn-jsc-sm", max_bucket=16, n_train=600,
                        backend="auto", device="cpu")
    assert eng.tuned_configs == {} and eng.auto is not None


def test_ragged_stream_compiles_once_per_bucket():
    """Twin of the reference's
    ``test_engine_ragged_stream_compiles_once_per_bucket``: a ragged
    stream builds at most one step per (backend, bucket), at ladder
    buckets only, and every request equals the oracle."""
    engine = ServingEngine("dwn-jsc-sm", max_bucket=64, min_bucket=8,
                           n_train=800, device="cpu")
    rng = np.random.default_rng(0)
    sizes = [5, 17, 64, 3, 100, 23, 64, 9, 2, 31]
    for n in sizes:
        engine.submit(engine.make_request(n, seed=int(rng.integers(2**31))))
    done = engine.drain()
    assert sum(r.size for r in done) == sum(sizes)
    counts = engine.compile_counts()
    assert 64 in counts["fused-packed"] and len(counts["fused-packed"]) > 1
    for backend, per_bucket in counts.items():
        assert set(per_bucket) <= set(engine.scheduler.buckets), backend
        assert all(v == 1 for v in per_bucket.values()), (backend,
                                                          per_bucket)
    assert engine.report()["compiles"] == counts
    oracle = engine.backends["float-oracle"]
    for r in done:
        c, p = oracle(torch.from_numpy(np.ascontiguousarray(r.payload)))
        np.testing.assert_array_equal(r.result[0], c.numpy())
        np.testing.assert_array_equal(r.result[1], p.numpy())
    rep = engine.report()
    assert rep["served"] == sum(sizes)
    assert rep["bit_exact_vs_oracle"] == {"fused-packed": True,
                                          "packed-eager": True}


def test_verification_probes_every_tuned_bucket():
    """The startup check runs every non-oracle backend at each bucket
    whose tuned config differs from the default, beside the largest."""
    eng = ServingEngine("dwn-jsc-sm", max_bucket=32, n_train=600,
                        device="cpu", verify=False)
    from repro_torch.kernels.autotune import FusedConfig
    eng.model.tuned_configs.update({8: FusedConfig("batch-major"),
                                    16: FusedConfig()})
    tb.verify_backends(eng.model, list(eng.backends.values()),
                       eng.data.x_test[:32])
    assert eng.compile_counts()["fused-packed"] == {8: 1, 32: 1}


def test_serve_cli_backend_auto_on_cpu(capsys, tmp_path, monkeypatch):
    """``--backend auto`` serves and reports each bucket's choice."""
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    assert serve.main(["--arch", "dwn-jsc-sm", "--reduced", "--requests",
                       "2", "--batch", "16", "--backend", "auto",
                       "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["datapath"] == "auto"
    assert sorted(rep["auto"]["choice"]) == ["16", "8"]
