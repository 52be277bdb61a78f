"""The DWN head on the LM backbone in the port against the reference on
the CPU: ``pool_features``, the ``lm-head`` workload, the ``dwn-lm-head``
spec, ``ServingEngine(..., dwn_head=...)`` and the serve CLI's
``--dwn-head``.

The reference's own engine does not run on this host (ROADMAP Queue 3,
fault 1: its host mesh), so the head is held to the reference's
functions: ``models.transformer.forward`` at tp = 1 (its params carried
across as numpy), ``workloads.lm_head.pool_features`` and
``core.model.apply_hard``.  Bars:

* ``pool_features`` on the same bf16 logits: the bf16 mean over the
  sequence exact; the features within 1e-6 (XLA's and torch's float32
  ``tanh`` differ by a few ulp).
* ``lm-head`` features from the reference's backbone and teacher: within
  5e-3, about two bf16 ulps of a pooled logit mean times 0.3 (the bf16
  products round differently, and XLA keeps some intermediates in float32);
  labels equal wherever the teacher's top two scores are 0.1 apart or
  more (on these seeds every label is equal).
* Head counts: exact (integers), against the port's and the reference's
  ``apply_hard`` on the features the engine returned.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.workloads import get_workload as jget_workload  # noqa: E402
from repro.workloads import lm_head as JH  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.model import apply_hard  # noqa: E402
from repro_torch.dwn import DWNArtifact, resolve_spec  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.workloads import get_workload, load_workload  # noqa: E402
from repro_torch.workloads import lm_head as TH  # noqa: E402

FEAT_TOL = 5e-3
MARGIN = 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_backbone():
    """The reference's reduced backbone params (its ``_backbone`` init,
    ``PRNGKey(0)`` at tp = 1) as numpy, and its teacher."""
    jp = JT.init_params(jax.random.PRNGKey(0), jget_arch("qwen3-8b").reduced(),
                        tp=1)
    return jax.tree.map(np.asarray, jp), np.asarray(JH._backbone()["Wt"])


@pytest.fixture(scope="module")
def head_artifact():
    """dwn-lm-head trained one epoch on the port's lm-head split (CPU),
    frozen and packed on the CPU."""
    data = load_workload("lm-head", 96, 32, seed=0, device="cpu")
    art = DWNArtifact(resolve_spec("dwn-lm-head")).train(
        data, epochs=1, batch=32, seed=0, device="cpu")
    return art.freeze().pack("cpu")


def test_pool_features_matches_reference():
    """On seeded bf16 logits: the pooled bf16 mean exact, the features
    within 1e-6; only the first 16 columns are read."""
    rng = np.random.default_rng(0)
    lg = (rng.standard_normal((8, 32, 40)) * 3).astype(np.float32)
    jl = jnp.asarray(lg).astype(jnp.bfloat16)
    tl = torch.from_numpy(lg).to(torch.bfloat16)
    want = np.asarray(JH.pool_features(jl))
    got = TH.pool_features(tl)
    assert got.dtype == torch.float32 and got.shape == (8, 16)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    mean_j = np.asarray(jl.mean(axis=1)[:, :16].astype(jnp.float32))
    mean_t = tl[..., :16].float().mean(1).to(torch.bfloat16).float()
    np.testing.assert_array_equal(mean_t.numpy(), mean_j)
    torch.testing.assert_close(TH.pool_features(tl[..., :16]), got,
                               rtol=0, atol=0)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2])
def test_lm_head_features_and_labels_match_reference(ref_backbone, seed):
    """With the reference's backbone and teacher carried in, 96 seeded
    sequences give the reference's features within FEAT_TOL and its
    labels; the port's narrow unembedding (16 columns) gives the full
    one's features exactly."""
    np_params, wt = ref_backbone
    cfg = get_arch("qwen3-8b").reduced()
    bb = TH.make_backbone("cpu", params=TT.params_from_numpy(np_params, cfg),
                          teacher=wt)
    jx, jy = JH._materialize(96, seed)
    tx, ty = TH._materialize(96, seed, backbone=bb)
    assert tx.shape == (96, 16) and tx.dtype == np.float32
    assert np.abs(tx - jx).max() <= FEAT_TOL
    scores = np.sort(jx @ wt, axis=1)
    near_tie = scores[:, -1] - scores[:, -2] < MARGIN
    assert not ((ty != jy) & ~near_tie).any()
    assert (ty == jy).all()                    # as it stands on these seeds
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 251, (8, 32)).astype(np.int32))
    full, _, _ = TT.forward(bb["params"], cfg, {"tokens": toks})
    narrow, _, _ = TT.forward(bb["params"], cfg, {"tokens": toks},
                              vocab_cols=16)
    assert narrow.shape == (8, 32, 16)
    assert torch.equal(narrow, full[..., :16])
    assert torch.equal(TH.head_features(bb["params"], cfg, toks),
                       TH.pool_features(full))


def test_lm_head_workload_schema_and_split():
    """The registry entry has the reference's schema (geometry, preset,
    backbone, caps, description); ``load_workload("lm-head", 96, 32)`` is
    deterministic, (96, 16) in [-1, 1), labels in 0..4, and cached per
    device."""
    mine, ref = get_workload("lm-head"), jget_workload("lm-head")
    for field in ("name", "num_features", "num_classes", "description",
                  "backbone", "cap_train", "cap_test"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert mine.presets.keys() == ref.presets.keys()
    for k in ("num_features", "bits_per_feature", "encoding", "lut_counts",
              "num_classes"):
        assert getattr(mine.presets["lm-head-50"], k) == \
            getattr(ref.presets["lm-head-50"], k)
    data = load_workload("lm-head", 96, 32, seed=0, device="cpu")
    again = TH.load_lm_head(96, 32, seed=0, device="cpu")
    assert again is data
    fresh = TH._materialize(96, 1, device="cpu")
    np.testing.assert_array_equal(fresh[0], data.x_train)
    np.testing.assert_array_equal(fresh[1], data.y_train)
    assert data.x_train.shape == (96, 16) and data.x_test.shape == (32, 16)
    assert data.x_train.min() >= -1.0 and data.x_train.max() < 1.0
    assert set(np.unique(data.y_train)) <= set(range(5))
    assert data.y_train.dtype == np.int32


def test_dwn_lm_head_spec_and_artifact_lifecycle(head_artifact, tmp_path):
    """``dwn-lm-head`` is the reference's spec (fingerprint included);
    trained, frozen, packed, saved and loaded, it classifies the same."""
    from repro.dwn import resolve_spec as jresolve
    spec = resolve_spec("dwn-lm-head")
    assert spec.to_dict() == jresolve("dwn-lm-head").to_dict()
    assert spec.fingerprint() == "45d5bf86faeb3b92"
    assert spec.dwn_config().lut_counts == (50,)
    art = head_artifact
    assert art.stage == "packed" and art.calibration["epochs"] == 1
    art.save(tmp_path / "head")
    back = DWNArtifact.load(tmp_path / "head", device="cpu")
    assert back.spec == spec and back.stage == "packed"
    x = torch.from_numpy(load_workload("lm-head", 96, 32, seed=0,
                                       device="cpu").x_test)
    assert torch.equal(apply_hard(back.frozen, x), apply_hard(art.frozen, x))


def _ref_frozen(art):
    """The port's frozen head as the reference's ``FrozenDWN``."""
    from repro.dwn import resolve_spec as jresolve
    f = art.frozen
    return JM.FrozenDWN(jresolve("dwn-lm-head").dwn_config(),
                        np.asarray(f.thresholds),
                        [np.asarray(i) for i in f.mapping_idx],
                        [np.asarray(t) for t in f.tables_bin],
                        input_frac_bits=f.input_frac_bits)


@pytest.mark.slow
def test_engine_serves_lm_and_classify_requests(head_artifact, tmp_path,
                                                ref_backbone):
    """One drain of a reduced-qwen3-8b engine with the head serves an LM
    request and a classify request; the startup gate passed; the counts
    equal the port's and the reference's ``apply_hard`` on the returned
    features; the report's ``dwn_head`` has the reference's keys.  A
    checkpoint path and a spec name attach too, and on the reference's
    backbone params the served features are the reference's."""
    eng = ServingEngine("qwen3-8b", reduced=True, prompt_len=8, gen=2,
                        seed=0, device="cpu", dwn_head=head_artifact)
    assert eng.head_bit_exact is True
    eng.submit(eng.make_request(2, seed=0))
    eng.submit(eng.make_request(4, seed=1, classify=True))
    done = eng.drain()
    assert [("pred" in r.result) for r in done] == [False, True]
    assert done[0].result["tokens"].shape == (2, 2)
    head = done[1].result
    assert head["pred"].shape == (4,) and head["counts"].shape == (4, 5)
    feats = torch.from_numpy(head["features"])
    assert feats.shape == (4, 16) and feats.dtype == torch.float32
    np.testing.assert_array_equal(
        head["counts"], apply_hard(head_artifact.frozen, feats).numpy())
    ref_counts = np.asarray(JM.apply_hard(_ref_frozen(head_artifact),
                                          jnp.asarray(head["features"])))
    np.testing.assert_array_equal(head["counts"], ref_counts)
    np.testing.assert_array_equal(head["pred"],
                                  np.argmax(ref_counts, axis=-1))
    rep = eng.report()
    assert {"spec", "spec_fingerprint", "artifact_stage",
            "bit_exact_vs_oracle", "served"} <= set(rep["dwn_head"])
    assert rep["dwn_head"]["bit_exact_vs_oracle"] is True
    assert rep["dwn_head"]["served"] == 4
    assert rep["dwn_head"]["spec_fingerprint"] == "45d5bf86faeb3b92"
    assert rep["dwn_head"]["datapath"] == "fused-packed"
    assert rep["served"] == 6 and rep["prefill_s"] >= 0

    # the same engine on the reference's backbone: the reference's
    # features within FEAT_TOL
    np_params, _ = ref_backbone
    cfg = get_arch("qwen3-8b").reduced()
    eng.params = TT.params_from_numpy(np_params, cfg)
    req = eng.make_request(4, seed=3, classify=True)
    eng.submit(req)
    got = eng.drain()[0].result
    jlog, _, _ = JT.forward(jax.tree.map(jnp.asarray, np_params),
                            jget_arch("qwen3-8b").reduced(),
                            {"tokens": jnp.asarray(req["tokens"])}, tp=1)
    want = np.asarray(JH.pool_features(jlog))
    assert np.abs(got["features"] - want).max() <= FEAT_TOL

    path = head_artifact.save(tmp_path / "ckpt")
    by_path = ServingEngine("qwen3-8b", reduced=True, prompt_len=8, gen=2,
                            device="cpu", dwn_head=str(path.parent))
    assert by_path.head_bit_exact is True
    assert by_path.head_artifact.spec == head_artifact.spec
    by_name = ServingEngine("qwen3-8b", reduced=True, prompt_len=8, gen=2,
                            device="cpu", dwn_head="dwn-lm-head")
    assert by_name.head_bit_exact is True
    assert by_name.head_artifact.calibration["n_fit"] == 512
    with pytest.raises(ValueError, match="dwn_head"):
        ServingEngine("qwen3-8b", reduced=True, device="cpu").make_request(
            2, classify=True)


def test_dwn_engine_refuses_dwn_head():
    """The reference's message: the head rides an LM backbone."""
    with pytest.raises(ValueError, match="LM engine"):
        ServingEngine("dwn-jsc-sm", dwn_head="dwn-lm-head", device="cpu")


@pytest.mark.slow
def test_serve_cli_dwn_head_on_the_cpu():
    """``--arch qwen3-8b --reduced --device cpu --dwn-head dwn-lm-head``:
    one LM request and one classify request, the report's ``dwn_head``
    with the gate passed and the batch served."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert serve.main(["--arch", "qwen3-8b", "--reduced", "--device",
                           "cpu", "--batch", "3", "--prompt-len", "8",
                           "--gen", "2", "--dwn-head", "dwn-lm-head"]) == 0
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rep["requests"] == 2 and rep["served"] == 6
    assert rep["dwn_head"]["bit_exact_vs_oracle"] is True
    assert rep["dwn_head"]["served"] == 3
    assert len(rep["head_sample"]) == 3 and len(rep["sample"]) == 2
    assert set(rep["head_sample"]) <= set(range(5))
