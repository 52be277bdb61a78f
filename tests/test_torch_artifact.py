"""DWN artifacts cross between the two packages on one on-disk layout.

A model the reference trained and saved loads in the port and serves
counts and predictions bit-exact to the reference's ``apply_hard_packed``;
a full-width dwn-jsc-lg the port fitted and saved loads in the reference
with equal frozen arrays and counts; the files and manifests either
package writes for the same state are the same.  Comparisons are exact.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.model import apply_hard_packed as japply_packed  # noqa: E402
from repro.data.jsc import load_jsc  # noqa: E402
from repro.dwn import DWNArtifact as JArtifact  # noqa: E402
from repro.dwn import DWNSpec as JSpec  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro_torch.core.model import apply_hard_packed  # noqa: E402
from repro_torch.dwn import DWNArtifact, DWNSpec  # noqa: E402
from repro_torch.dwn import LifecycleError, get_spec  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


@pytest.fixture(scope="module")
def data():
    return load_jsc(512, 128)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, data):
    """The reference's case of ``tests/test_dwn_api.py``: sm-10, PEN,
    T = 32, 5 input bits, one epoch, saved packed."""
    spec = JSpec(preset="sm-10", variant="PEN", bits=32, input_bits=5)
    art = JArtifact(spec).train(data, epochs=1, batch=64).freeze().pack()
    path = tmp_path_factory.mktemp("ref_ckpt")
    art.save(path)
    return art, path


def _manifest(path, step=0):
    m = json.loads((path / f"step_{step:08d}" / "manifest.json").read_text())
    m.pop("created")
    return m


def test_reference_trained_artifact_serves_bit_exact_in_the_port(trained,
                                                                 data):
    """Exact: the port loads the reference's checkpoint (stage, spec,
    fingerprint, calibration and params as saved) and serves it on the
    CPU with the counts and predictions of the reference's
    ``apply_hard_packed``."""
    jart, path = trained
    art = DWNArtifact.load(path, device="cpu")
    assert art.stage == "packed" and art.packed.device.type == "cpu"
    assert art.spec.to_dict() == jart.spec.to_dict()
    assert art.spec.fingerprint() == jart.spec.fingerprint()
    assert art.calibration == jart.calibration
    assert art.calibration["epochs"] == 1
    for got, want in zip(art.params["layers"], jart.params["layers"]):
        for k in ("scores", "tables"):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    np.testing.assert_array_equal(art.buffers["thresholds"].numpy(),
                                  np.asarray(jart.buffers["thresholds"]))
    assert art.summary()["fingerprint"] == jart.summary()["fingerprint"]

    x = data.x_test[:96]
    want = np.asarray(japply_packed(jart.frozen, jnp.asarray(x)))
    want_pred = np.argmax(want, axis=1)
    got = apply_hard_packed(art.frozen, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    eng = ServingEngine(art, max_bucket=64, min_bucket=8, n_train=512,
                        device="cpu")
    assert eng.bit_exact == {"fused-packed": True, "packed-eager": True}
    for size in (64, 17, 15):
        eng.submit(x[:size])
    for r in eng.drain():
        np.testing.assert_array_equal(r.result[0], want[:r.size])
        np.testing.assert_array_equal(r.result[1], want_pred[:r.size])
    assert eng.report()["spec_fingerprint"] == jart.spec.fingerprint()


def test_port_writes_the_reference_layout(trained, tmp_path):
    """Exact: the reference's checkpoint loaded and saved again by the
    port gives the same files, leaf paths, shapes, dtypes, sha256 and
    manifest ``extra``; the commit marker is there."""
    _, path = trained
    art = DWNArtifact.load(path, device="cpu")
    out = art.save(tmp_path, step=3)
    assert out == tmp_path / "step_00000003"
    assert (tmp_path / "step_00000003.COMMITTED").exists()
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in (path / "step_00000000").iterdir())
    mine, ref = _manifest(tmp_path, 3), _manifest(path)
    assert mine.pop("step") == 3 and ref.pop("step") == 0
    assert list(mine["leaves"]) == list(ref["leaves"])
    assert mine == ref
    assert "params/layers/0/scores" in mine["leaves"]
    assert mine["leaves"]["frozen/mapping_idx/0"]["file"] == \
        "frozen__mapping_idx__0.npy"
    assert ckpt.latest_step(tmp_path) == 3


def test_port_saved_full_width_lg_loads_in_the_reference(tmp_path):
    """Exact: the port fits, freezes and saves dwn-jsc-lg (lg-2400, T =
    200) at full width; the reference's ``load_artifact`` reads it with
    the port's frozen arrays and params, and its ``apply_hard_packed``
    counts equal the port's."""
    d = load_jsc(600, 64, seed=1)
    art = DWNArtifact(get_spec("dwn-jsc-lg")).fit(d.x_train, seed=3)
    art.freeze().pack("cpu")
    art.save(tmp_path)
    jart = jckpt.load_artifact(tmp_path)
    assert jart.stage == "packed"
    assert jart.spec.fingerprint() == art.spec.fingerprint()
    assert jart.calibration == art.calibration
    np.testing.assert_array_equal(jart.frozen.thresholds,
                                  art.frozen.thresholds)
    for a, b in zip(jart.frozen.mapping_idx, art.frozen.mapping_idx):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jart.frozen.tables_bin, art.frozen.tables_bin):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.asarray(jart.params["layers"][0]["tables"]),
        art.params["layers"][0]["tables"].numpy())
    want = np.asarray(japply_packed(jart.frozen, jnp.asarray(d.x_test)))
    got = apply_hard_packed(art.frozen, torch.from_numpy(d.x_test)).numpy()
    np.testing.assert_array_equal(got, want)


def test_frozen_stage_artifact_crosses(tmp_path, data):
    """A port artifact saved frozen (no packed stage) loads frozen in both
    packages; loading it needs no device."""
    art = DWNArtifact(get_spec("dwn-jsc-sm")).fit(data.x_train).freeze()
    ckpt.save_artifact(tmp_path, art)
    again = ckpt.load_artifact(tmp_path)
    assert again.stage == "frozen" and again.packed is None
    assert jckpt.load_artifact(tmp_path).stage == "frozen"
    np.testing.assert_array_equal(again.frozen.thresholds,
                                  art.frozen.thresholds)


def test_hw_stages_need_a_frozen_artifact(data):
    """``hw_report``, ``verilog`` and ``verify_rtl`` raise
    ``LifecycleError`` before ``freeze()``; the bare functions refuse an
    unfrozen artifact with ``ValueError``, and a bare frozen model needs
    ``variant=`` and ``name=``."""
    from repro_torch.hw import cosim as hw_cosim
    from repro_torch.hw import cost as hw_cost
    from repro_torch.hw import verilog as hw_verilog
    art = DWNArtifact(DWNSpec(preset="sm-10", variant="PEN", input_bits=6))
    for _ in ("spec", "trained"):
        for method in (art.hw_report, art.verilog, art.verify_rtl):
            with pytest.raises(LifecycleError, match="freeze"):
                method()
        for fn in (hw_cost.dwn_hw_report, hw_verilog.emit_dwn,
                   hw_cosim.verify_rtl):
            with pytest.raises(ValueError, match="freeze"):
                fn(art)
        art.fit(data.x_train)
    art.freeze()
    assert hw_cost.dwn_hw_report(art).luts == art.hw_report().luts
    with pytest.raises(TypeError, match="variant"):
        hw_cost.dwn_hw_report(art.frozen)


def test_reference_saved_artifact_has_the_reference_hardware(trained):
    """Exact: the reference's saved PEN artifact, loaded by the port, has
    the reference's cost report and emits its Verilog byte for byte; its
    RTL co-simulates against the port's oracle."""
    jart, path = trained
    art = DWNArtifact.load(path, device="cpu")
    got, want = art.hw_report(), jart.hw_report()
    for field in ("luts", "ffs", "levels", "distinct_comparators",
                  "delay_ns", "fmax_mhz", "area_delay"):
        assert getattr(got, field) == getattr(want, field), field
    assert art.verilog() == jart.verilog()
    x = load_jsc(512, 64, seed=1).x_test
    assert art.verify_rtl(x, backend="python").counts_checked
    assert art.calibration["rtl_verified"]["n_vectors"] == 64


def test_load_artifact_refusals(tmp_path, trained):
    """An empty directory raises FileNotFoundError, a checkpoint that is
    not an artifact ValueError, a tampered leaf a checksum error."""
    with pytest.raises(FileNotFoundError):
        ckpt.load_artifact(tmp_path / "empty")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        DWNArtifact.load(tmp_path / "empty", device="cpu")
    ckpt.save(tmp_path / "raw", 0, {"w": np.zeros(3)})
    with pytest.raises(ValueError, match="not a DWN artifact"):
        ckpt.load_artifact(tmp_path / "raw")
    _, path = trained
    bad = tmp_path / "tampered"
    bad_step = bad / "step_00000000"
    bad_step.mkdir(parents=True)
    for f in (path / "step_00000000").iterdir():
        (bad_step / f.name).write_bytes(f.read_bytes())
    (bad / "step_00000000.COMMITTED").write_text("0")
    leaf = bad_step / "frozen__tables_bin__0.npy"
    arr = np.load(leaf)
    arr.flat[0] ^= 1
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum mismatch"):
        ckpt.load_artifact(bad, device="cpu")


def test_tree_checkpoints_cross_and_collect(tmp_path):
    """Exact: a nested tree of tensors and arrays saved by the port
    restores in the reference (and back), an uncommitted step is not the
    latest, and ``garbage_collect`` keeps the newest."""
    tree = {"b": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  np.ones((4,), np.float32)],
            "a": {"z": np.float32(2.5) * np.ones((2, 2), np.float32)}}
    for step in (1, 2, 5):
        ckpt.save(tmp_path, step, tree, extra={"step": step})
    (tmp_path / "step_00000009").mkdir()        # no marker: not committed
    assert ckpt.latest_step(tmp_path) == 5
    jtree, extra = jckpt.restore(tmp_path, 5, jax.tree_util.tree_map(
        np.asarray, {"b": [np.zeros((2, 3), np.int32),
                           np.zeros(4, np.float32)],
                     "a": {"z": np.zeros((2, 2), np.float32)}}))
    assert extra == {"step": 5}
    np.testing.assert_array_equal(np.asarray(jtree["b"][0]),
                                  tree["b"][0].numpy())
    step, back, _ = ckpt.restore_latest(tmp_path, tree)
    assert step == 5 and back["b"][0].dtype == torch.int32
    np.testing.assert_array_equal(back["a"]["z"].numpy(), tree["a"]["z"])
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, 5, {"b": [np.zeros((3, 3)), np.zeros(4)],
                                   "a": {"z": np.zeros((2, 2))}})
    ckpt.garbage_collect(tmp_path, keep=1)
    assert ckpt.latest_step(tmp_path) == 5
    assert not (tmp_path / "step_00000001").exists()
    assert jckpt.latest_step(tmp_path) == 5
