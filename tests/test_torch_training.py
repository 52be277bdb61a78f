"""Port vs reference: DWN training (``training/*``, ``core/training.py``,
``core/warmstart.py``, ``core/quantize.py``, ``DWNArtifact.train`` and
``launch/train.py``), on the CPU.

Both packages start from the reference's init, carried across with
``params_from_numpy``, and walk the same batch order (the epoch
permutation is numpy's in both).  The engine is held to the reference's
engine by the reference's own bars for its engine against its loop
(``tests/test_training.py``): per-epoch loss within 1e-5, test accuracy
within 1e-6, table signs identical, scores within 1e-4.  The port's loop
and its engine, and a multi-seed run and its sequential runs, take the
same arithmetic in another order and are held to the same bars.  Bits,
permutations, thresholds and hard-path accuracies are exact.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import JSC_PRESETS as J_PRESETS  # noqa: E402
from repro.core import train_dwn as j_train_dwn  # noqa: E402
from repro.core.model import init_dwn as j_init_dwn  # noqa: E402
from repro.data.jsc import batches, load_jsc  # noqa: E402
from repro.training import engine as jengine  # noqa: E402
from repro_torch.core import model as tm  # noqa: E402
from repro_torch.training import engine as tengine  # noqa: E402
from repro_torch.training import (ScanTrainer, train_dwn_batch,  # noqa: E402
                                  train_dwn_reference)

LOSS_TOL, ACC_TOL, SCORES_TOL = 1e-5, 1e-6, 1e-4
CFG = tm.JSC_PRESETS["sm-50"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a torch pool over every core in each of them slows all
    of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return load_jsc(2000, 500, seed=0)


def _carried(data, seed=0):
    p, b = j_init_dwn(jax.random.PRNGKey(seed), J_PRESETS["sm-50"],
                      data.x_train)
    return (p, b), tm.params_from_numpy(p, b)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _same_run(got, want):
    """The reference's bars: loss, accuracy, table signs, scores."""
    lg = np.array([h["loss"] for h in got.history])
    lw = np.array([h["loss"] for h in want.history])
    assert lg.shape == lw.shape and np.abs(lg - lw).max() < LOSS_TOL
    for hg, hw in zip(got.history, want.history):
        if hw["test_acc"] is not None:
            assert abs(hg["test_acc"] - hw["test_acc"]) < ACC_TOL
    for lyr_g, lyr_w in zip(got.params["layers"], want.params["layers"]):
        np.testing.assert_array_equal(_np(lyr_g["tables"]) > 0,
                                      _np(lyr_w["tables"]) > 0)
        assert np.abs(_np(lyr_g["scores"])
                      - _np(lyr_w["scores"])).max() < SCORES_TOL


@pytest.fixture(scope="module")
def engine_pair(data):
    """(reference engine, port engine) from the reference's init."""
    (p, b), (tp, tb) = _carried(data)
    ref = j_train_dwn(J_PRESETS["sm-50"], data, epochs=3, batch=128,
                      seed=0, params=p, buffers=b, verbose=False)
    port = ScanTrainer(CFG, data, batch=128, seed=0, params=tp, buffers=tb,
                       device="cpu").train(3)
    return ref, port


def test_epoch_permutation_matches_reference(data):
    """Exact: the permutation is the reference's byte for byte, and the
    order of ``data.jsc.batches``."""
    n = data.x_train.shape[0]
    for seed, epoch in ((0, 0), (3, 1), (3, 7)):
        got = tengine.epoch_permutation(n, n // 128, 128, seed=seed,
                                        epoch=epoch)
        want = jengine.epoch_permutation(n, n // 128, 128, seed=seed,
                                         epoch=epoch)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        order = np.concatenate([xb for xb, _ in batches(
            data.x_train, data.y_train, 128, seed=seed, epoch=epoch)])
        np.testing.assert_array_equal(order, data.x_train[got])


@pytest.mark.parametrize("frac", [None, 8])
def test_encode_dataset_matches_reference(data, frac):
    """Exact: the uint8 bit rows of the whole split, TEN and PEN (1, 8)."""
    (_, b), (_, tb) = _carried(data)
    want = np.asarray(jengine.encode_dataset(data.x_train, b["thresholds"],
                                             input_frac_bits=frac))
    got = tengine.encode_dataset(data.x_train, tb["thresholds"],
                                 input_frac_bits=frac)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_matches_reference_engine_loss(engine_pair):
    """Per-epoch loss within 1e-5 of the reference engine's, 3 epochs of
    batch 128 at sm-50 on load_jsc(2000, 500)."""
    ref, port = engine_pair
    lr = np.array([h["loss"] for h in ref.history])
    lp = np.array([h["loss"] for h in port.history])
    assert len(lp) == 3 and np.abs(lr - lp).max() < LOSS_TOL


def test_engine_matches_reference_engine_accuracy_and_params(engine_pair):
    """Accuracy within 1e-6 each epoch, table signs identical, scores
    within 1e-4, and the same frozen model."""
    ref, port = engine_pair
    _same_run(port, ref)
    from repro.core.model import freeze as j_freeze
    fj = j_freeze(ref.params, ref.buffers, J_PRESETS["sm-50"])
    ft = tm.freeze(port.params, port.buffers, CFG)
    for a, b in zip(ft.mapping_idx + ft.tables_bin,
                    fj.mapping_idx + fj.tables_bin):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_pen_engine_matches_reference(data):
    """The reference's bars with PEN (1, 8) features and thresholds
    (``input_frac_bits``), 2 epochs."""
    (p, b), (tp, tb) = _carried(data, seed=2)
    q = {"thresholds": jnp.round(b["thresholds"] * 256) / 256}
    tq = {"thresholds": torch.round(tb["thresholds"] * 256) / 256}
    ref = j_train_dwn(J_PRESETS["sm-50"], data, epochs=2, seed=2, params=p,
                      buffers=q, input_frac_bits=8, verbose=False)
    port = tengine.train_dwn_scan(CFG, data, epochs=2, seed=2, params=tp,
                                  buffers=tq, input_frac_bits=8,
                                  verbose=False, device="cpu")
    _same_run(port, ref)


def test_loop_trainer_equals_scan_engine(data, engine_pair):
    """The port's per-minibatch loop (textbook STE, three-pass Adam, the
    batch encoded every step) meets its engine within the same bars."""
    _, port = engine_pair
    _, (tp, tb) = _carried(data)
    loop = train_dwn_reference(CFG, data, epochs=3, params=tp, buffers=tb,
                               device="cpu")
    _same_run(loop, port)


def test_train_dwn_batch_equals_sequential_runs(data):
    """A two-seed run equals two sequential ``train_dwn_scan`` runs within
    1e-5 (here bit for bit: the same program, in turn); without a process
    group ``data_parallel=True`` trains alone, as the reference does on
    one device, and gives the same members."""
    out = train_dwn_batch(CFG, data, epochs=2, seeds=(0, 1), device="cpu")
    assert out.data_parallel is False and len(out.results) == 2
    for s, got in zip((0, 1), out.results):
        want = tengine.train_dwn_scan(CFG, data, epochs=2, seed=s,
                                      eval_every=0, verbose=False,
                                      device="cpu")
        lg = np.array([h["loss"] for h in got.history])
        lw = np.array([h["loss"] for h in want.history])
        assert np.abs(lg - lw).max() < LOSS_TOL
        assert abs(got.soft_test_acc - want.soft_test_acc) < ACC_TOL
    alone = train_dwn_batch(CFG, data, epochs=1, seeds=(0, 1),
                            data_parallel=True, device="cpu")
    assert alone.data_parallel is False and len(alone.results) == 2
    once = train_dwn_batch(CFG, data, epochs=1, seeds=(0, 1), device="cpu")
    for a, b in zip(alone.results, once.results):
        assert a.history[0]["loss"] == b.history[0]["loss"]


def test_interleaved_trainers_share_one_program(data):
    """Exact: two trainers of one shape share the cached step program;
    run in turns, each ends where it would alone, and the caller's warm
    start is never written."""
    _, (tp, tb) = _carried(data)
    snap = [t.clone() for layer in tp["layers"] for t in layer.values()]
    a = ScanTrainer(CFG, data, seed=0, params=tp, buffers=tb, device="cpu")
    b = ScanTrainer(CFG, data, seed=1, device="cpu")
    assert a.program is b.program
    la = [a.run_epochs(1), b.run_epochs(1), a.run_epochs(1)]
    alone = ScanTrainer(CFG, data, seed=0, params=tp, buffers=tb,
                        device="cpu").run_epochs(2)
    np.testing.assert_array_equal(np.concatenate([la[0], la[2]]), alone)
    assert int(a.opt_state.step) == 2 * a.steps_per_epoch
    for t, s in zip((t for layer in tp["layers"] for t in layer.values()),
                    snap):
        assert torch.equal(t, s)


def test_schedule_crosses_its_boundary_at_the_reference_step(data):
    """Exact: ``steps_per_epoch`` optimizer steps an epoch (drop the
    remainder), and StepLR's rate falls 10x at step 30 * steps_per_epoch."""
    tr = ScanTrainer(CFG, data, batch=128, seed=0, device="cpu")
    spe = tr.steps_per_epoch
    assert spe == data.x_train.shape[0] // 128
    tr.run_epochs(2)
    assert int(tr.opt_state.step) == 2 * spe
    assert float(tr.opt.lr_at(torch.tensor(30 * spe - 1))) == \
        pytest.approx(1e-3)
    assert float(tr.opt.lr_at(torch.tensor(30 * spe))) == \
        pytest.approx(1e-4)


def test_eval_soft_matches_reference(data):
    """Within 1e-6: the soft accuracy of the same params, streamed in
    batches of 128 and averaged by batch size."""
    from repro.core.training import eval_soft as j_eval_soft
    from repro_torch.core.training import eval_soft
    (p, b), (tp, tb) = _carried(data)
    for frac in (None, 6):
        want = j_eval_soft(p, b, J_PRESETS["sm-50"], data.x_test,
                           data.y_test, frac, batch=128)
        got = eval_soft(tp, tb, CFG, data.x_test, data.y_test, frac,
                        batch=128)
        assert abs(got - want) < ACC_TOL


def test_warmstart_matches_reference(data):
    """Exact: the warm-started first layer from the same init."""
    from repro.core.warmstart import warmstart_dwn as j_warmstart
    from repro_torch.core.warmstart import warmstart_params
    cfg = J_PRESETS["sm-10"]
    pj, bj = j_warmstart(jax.random.PRNGKey(4), cfg, data.x_train,
                         data.y_train)
    p0, b0 = j_init_dwn(jax.random.PRNGKey(4), cfg, data.x_train)
    tp, tb = tm.params_from_numpy(p0, b0)
    got, _ = warmstart_params(tp, tb, tm.JSC_PRESETS["sm-10"], data.x_train,
                              data.y_train)
    for k in ("scores", "tables"):
        np.testing.assert_array_equal(got["layers"][0][k].numpy(),
                                      np.asarray(pj["layers"][0][k]))


def test_ptq_search_matches_reference(engine_pair, data):
    """Exact: the PEN bit-width sweep of a trained model (hard-path
    accuracy at each width) and the width it settles on."""
    from repro.core.quantize import ptq_bitwidth_search as j_ptq
    from repro_torch.core.quantize import ptq_bitwidth_search
    ref, port = engine_pair
    want = j_ptq(ref.params, ref.buffers, J_PRESETS["sm-50"], data, 0.55,
                 max_frac=8, verbose=False)
    got = ptq_bitwidth_search(port.params, port.buffers, CFG, data, 0.55,
                              max_frac=8, verbose=False)
    assert (got.total_bits, got.frac_bits) == (want.total_bits,
                                               want.frac_bits)
    assert got.sweep == want.sweep


def test_finetune_search_runs_and_matches_reference(engine_pair, data):
    """The fine-tune sweep (1 epoch a width, widths 7 and 6) gives the
    reference's hard-path accuracies exactly from the same model."""
    from repro.core.quantize import finetune_bitwidth_search as j_ft
    from repro_torch.core.quantize import finetune_bitwidth_search
    ref, port = engine_pair
    (p, b), (tp, tb) = _carried(data)
    want = j_ft(p, b, J_PRESETS["sm-50"], data, 0.0, start_frac=7,
                min_frac=6, epochs=1, verbose=False)
    got = finetune_bitwidth_search(tp, tb, CFG, data, 0.0, start_frac=7,
                                   min_frac=6, epochs=1, verbose=False,
                                   device="cpu")
    assert got.sweep == want.sweep and got.frac_bits == want.frac_bits


def test_launch_train_prints_the_reference_report(capsys, tmp_path):
    """The CLI (``--reduced --epochs 1 --device cpu``) prints the
    reference's report keys, plus the device, for one seed and for two
    (with artifacts); LM archs train through the LM branch (the same
    CLI, ``--reduced --steps 2 --device cpu``): the dense qwen3-8b and,
    since the SSM family is ported, the reduced mamba2-1.3b, with finite
    losses."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    reports = {}
    for pkg, main, extra in ((
            "ref", jtrain.main, []), ("port", ttrain.main,
                                      ["--device", "cpu"])):
        for seeds in ("0", "0,1"):
            argv = ["--arch", "dwn-jsc-sm", "--reduced", "--epochs", "1",
                    "--workload", "jsc", "--seeds", seeds, "--quiet",
                    "--artifact-dir", str(tmp_path / pkg / seeds)]
            assert main(argv + extra) == 0
            reports[pkg, seeds] = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
    for seeds in ("0", "0,1"):
        ref, port = reports["ref", seeds], reports["port", seeds]
        assert set(port) - set(ref) == {"device"}
        assert set(ref) <= set(port)
        assert port["spec_fingerprint"] == ref["spec_fingerprint"]
        assert [a["stage"] for a in port["artifacts"]] == \
            [a["stage"] for a in ref["artifacts"]]
    assert reports["port", "0,1"]["vmapped"] is False
    assert ttrain.main(["--arch", "qwen3-8b", "--reduced", "--steps", "2",
                        "--seq", "16", "--device", "cpu"]) == 0
    lm = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (lm["arch"], lm["steps"], lm["device"]) == \
        ("qwen3-8b-reduced", 2, "cpu")
    assert np.isfinite(lm["first_loss"]) and np.isfinite(lm["last_loss"])
    assert ttrain.main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "2",
                        "--seq", "16", "--device", "cpu"]) == 0
    ssm = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (ssm["arch"], ssm["steps"]) == ("mamba2-1.3b-reduced", 2)
    assert np.isfinite(ssm["first_loss"]) and np.isfinite(ssm["last_loss"])


def test_trained_artifact_saves_loads_and_serves_bit_exact(data, tmp_path):
    """Exact: ``DWNArtifact.train`` on the CPU, frozen, packed, saved,
    loaded and served: every request's counts and predictions equal
    ``apply_hard``'s; the calibration and history carry the reference's
    keys."""
    from repro.dwn import DWNArtifact as JArtifact
    from repro.dwn import get_spec as j_get_spec
    from repro_torch.dwn import DWNArtifact, get_spec
    from repro_torch.serving import ServingEngine
    art = DWNArtifact(get_spec("dwn-jsc-sm")).train(data, epochs=1,
                                                    device="cpu")
    ref = JArtifact(j_get_spec("dwn-jsc-sm")).train(data, epochs=1)
    assert set(art.calibration) == set(ref.calibration)
    assert [set(h) for h in art.history] == [set(h) for h in ref.history]
    art.freeze().pack("cpu").save(tmp_path)
    loaded = DWNArtifact.load(tmp_path, device="cpu")
    assert loaded.stage == "packed"
    assert loaded.calibration == art.calibration
    engine = ServingEngine(loaded, device="cpu", max_bucket=256)
    assert all(engine.bit_exact.values())
    for i in range(3):
        engine.submit(engine.make_request(100 + i, seed=i))
    for r in engine.drain():
        want = tm.apply_hard(art.frozen, torch.from_numpy(r.payload))
        np.testing.assert_array_equal(r.result[0], want.numpy())
        np.testing.assert_array_equal(
            r.result[1], torch.argmax(want, -1).numpy())


def test_training_entry_points_refuse_to_run_without_a_card(data):
    """Without ``device="cpu"`` the trainer asks for CUDA and raises here:
    no silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScanTrainer(CFG, data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_dwn_reference(CFG, data, epochs=1)
