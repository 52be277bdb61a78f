"""The serving slice as a whole: a model the reference built, served by the
reference's engine and by the port's engine on the same request stream.

The reference fits ``dwn-jsc-sm`` and ``dwn-jsc-lg`` (its own ``jax.random``
init); the parameters cross to the port as numpy.  Per-request counts and
predictions must be identical (exact: integers), and the port's startup
``verify_backends`` must pass.
"""

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
        DWNSpec(preset="sm-50", datapath="packed-xla")


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
