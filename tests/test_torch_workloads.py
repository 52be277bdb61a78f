"""Port vs reference: the MNIST workload (``workloads/mnist.py``), its
``dwn-mnist-*`` spec presets served by the port, the entry points that
take them, and the lifecycle smoke CLI (``dwn/smoke.py``), on the CPU.

Data splits are byte-identical; counts and predictions are exact (small
integers held in float32).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.model import apply_hard as japply_hard  # noqa: E402
from repro.dwn import DWNArtifact as JArtifact  # noqa: E402
from repro.dwn import get_spec as jget_spec  # noqa: E402
from repro.workloads import mnist as jmnist  # noqa: E402
from repro_torch.core.model import apply_hard, params_from_numpy  # noqa: E402
from repro_torch.dwn import DWNArtifact, get_spec  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.workloads import get_workload, mnist  # noqa: E402

SPLIT_FIELDS = ("x_train", "y_train", "x_test", "y_test")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a torch pool over every core in each of them slows all
    of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_real_mnist(monkeypatch, tmp_path):
    """Point the npz cache at a file that does not exist, so every test
    here reads the synthetic digits unless it writes its own npz."""
    monkeypatch.setenv("REPRO_MNIST", str(tmp_path / "absent.npz"))
    monkeypatch.delenv("REPRO_MNIST_DOWNLOAD", raising=False)


def _assert_same_split(got, want):
    for field in SPLIT_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("n_train,n_test,seed",
                         [(200, 50, 0), (1000, 300, 3), (64, 1, 7),
                          (20000, 5000, 0)])
def test_load_mnist_is_byte_exact(n_train, n_test, seed):
    """Exact: the synthetic digits (master seed 20260), normalised with
    train-split statistics, in both packages and through the registry."""
    want = jmnist.load_mnist(n_train, n_test, seed=seed)
    _assert_same_split(mnist.load_mnist(n_train, n_test, seed=seed), want)
    _assert_same_split(get_workload("mnist").load(n_train, n_test, seed),
                       want)
    assert want.x_train.shape == (n_train, 196)


def test_real_npz_path_is_byte_exact(tmp_path, monkeypatch):
    """Exact: a tiny npz in the Keras layout goes through the real-data
    path (2x2 pooling to 14x14, seeded row choice) as in the reference."""
    rng = np.random.default_rng(11)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.integers(0, 256, (120, 28, 28), np.uint8),
             y_train=rng.integers(0, 10, 120).astype(np.uint8),
             x_test=rng.integers(0, 256, (40, 28, 28), np.uint8),
             y_test=rng.integers(0, 10, 40).astype(np.uint8))
    monkeypatch.setenv("REPRO_MNIST", str(path))
    for seed in (0, 5):
        want = jmnist.load_mnist(100, 30, seed=seed)
        _assert_same_split(mnist.load_mnist(100, 30, seed=seed), want)
    synthetic = jmnist._sample_synthetic(100, np.random.default_rng(0))[0]
    assert not np.array_equal(want.x_train[:, :5], synthetic[:, :5])


def test_the_port_never_downloads(monkeypatch):
    """With ``REPRO_MNIST_DOWNLOAD=1`` and no cached npz the port warns
    that it does not download and serves the synthetic digits; the module
    holds no URL and imports nothing that reaches the network."""
    import inspect
    want = jmnist.load_mnist(100, 20, seed=1)     # before the variable
    monkeypatch.setenv("REPRO_MNIST_DOWNLOAD", "1")
    with pytest.warns(UserWarning, match="does not download"):
        got = mnist.load_mnist(100, 20, seed=1)
    _assert_same_split(got, want)
    src = inspect.getsource(mnist)
    assert "http" not in src and "urllib" not in src


def test_mnist_presets_equal_the_reference():
    """Exact: the workload's tiers are the reference's DWN configs."""
    from dataclasses import asdict
    wl, jwl = get_workload("mnist"), jmnist.MNIST
    assert (wl.num_features, wl.num_classes) == (196, 10)
    assert sorted(wl.presets) == sorted(jwl.presets)
    for tier, cfg in wl.presets.items():
        assert asdict(cfg) == asdict(jwl.presets[tier]), tier


def _carried(name, n_train=400):
    """The reference's fit of ``name`` and the port's artifact adopting
    its numpy parameters."""
    from repro.workloads import load_workload
    data = load_workload("mnist", n_train, 64, seed=0)
    jart = JArtifact(jget_spec(name)).fit(data.x_train, seed=0)
    params, buffers = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jart.params),
        {"thresholds": np.asarray(jart.buffers["thresholds"])})
    return jart.freeze(), DWNArtifact(get_spec(name)).adopt(params, buffers)


@pytest.mark.parametrize("name", ["dwn-mnist-sm", "dwn-mnist-md",
                                  "dwn-mnist-lg"])
def test_mnist_tier_serves_bit_exact_on_cpu(name):
    """Exact: the port's engine serves each MNIST tier (the reference's
    parameters) on a ragged stream with every backend passing the startup
    oracle check; every request's counts and predictions equal the port's
    ``apply_hard`` and the reference's ``apply_hard`` on the same rows."""
    jart, art = _carried(name)
    engine = ServingEngine(art, max_bucket=64, min_bucket=8, n_train=400,
                           seed=0, device="cpu")
    assert engine.bit_exact == {"fused-packed": True, "packed-eager": True}
    for i, size in enumerate((64, 5, 33, 1, 17)):
        engine.submit(engine.make_request(size, seed=i))
    done = engine.drain()
    for r in done:
        x = np.ascontiguousarray(r.payload, np.float32)
        want = apply_hard(engine.artifact.frozen, torch.from_numpy(x))
        np.testing.assert_array_equal(r.result[0], want.numpy())
        np.testing.assert_array_equal(
            r.result[0], np.asarray(japply_hard(jart.frozen, jnp.asarray(x))))
        np.testing.assert_array_equal(r.result[1],
                                      r.result[0].argmax(-1))
    assert engine.report()["spec_fingerprint"] == \
        jget_spec(name).fingerprint()


def test_mnist_fingerprints_do_not_share_tuned_entries():
    """The tuner's cache key of an MNIST spec (its fingerprint) differs
    from every JSC spec's, so no JSC entry is reused for MNIST."""
    from repro_torch.dwn import dwn_names, resolve_spec
    from repro_torch.kernels.autotune import cache_key
    jsc = {resolve_spec(n).fingerprint() for n in dwn_names()
           if resolve_spec(n).workload == "jsc"}
    mnist_fps = {get_spec(f"dwn-mnist-{t}{s}").fingerprint()
                 for t in ("sm", "md", "lg") for s in ("", "-xla")}
    assert len(mnist_fps) == 6 and not mnist_fps & jsc
    keys = {cache_key(fp, 4096, "NVIDIA H100 80GB HBM3") for fp in jsc}
    assert not {cache_key(fp, 4096, "NVIDIA H100 80GB HBM3")
                for fp in mnist_fps} & keys


def test_serve_and_train_clis_take_mnist_archs(capsys):
    """``launch.serve`` and ``launch.train`` take ``--arch dwn-mnist-*``
    with no code of their own: the served stream is bit-exact against the
    oracle and training reports the MNIST workload."""
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", "dwn-mnist-sm", "--reduced", "--requests",
                       "2", "--batch", "64", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["bit_exact_vs_oracle"] == {"fused-packed": True,
                                          "packed-eager": True}
    assert rep["spec"]["workload"] == "mnist" and rep["served"] == 128
    assert train.main(["--arch", "dwn-mnist-sm", "--workload", "mnist",
                       "--reduced", "--epochs", "1", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["workload"] == "mnist" and rep["spec"]["preset"] == "mnist-sm"


def test_smoke_cli_runs_the_lifecycle_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.dwn.smoke --device cpu`` at mnist-sm on a
    few hundred rows: train, hw report, Verilog, serve, checkpoint,
    reload, bit-exact re-serve; exit 0."""
    from repro_torch.dwn import smoke
    out = tmp_path / "smoke.json"
    assert smoke.main(["--workload", "mnist", "--preset", "mnist-sm",
                       "--variant", "TEN", "--bits", "8", "--epochs", "1",
                       "--n-train", "300", "--n-test", "64", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
                       "--out", str(out), "--quiet"]) == 0
    rec = json.loads(out.read_text())
    assert rec["roundtrip_bit_exact"] and rec["reloaded_stage"] == "packed"
    assert rec["serve"]["bit_exact_vs_oracle"] == {"fused-packed": True,
                                                   "packed-eager": True}
    assert rec["hw"]["luts"]["lut_layer"] == 100 and \
        rec["hw"]["luts"]["encoder"] == 0
    assert rec["fingerprint"] == jget_spec("dwn-mnist-sm").fingerprint()
    assert rec["verilog_lines"] > 100
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
