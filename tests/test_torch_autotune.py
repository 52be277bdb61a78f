"""The port's fused-kernel tuner against the reference's cases
(``tests/test_autotune.py``): a deterministic winner under a stubbed
clock, cache persistence and invalidation, a cold start on an absent or
corrupt cache, both variants among the candidates, and every candidate
bit-exact to the reference's plain fused kernel.  Where the reference
falls back to its default when every candidate fails, the port raises
(only a candidate refused before any launch is skipped).  On the CPU the
wrappers run their plain versions; the card's timings are
``chip_smoke.py``'s."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused.ref import fused_dwn_packed_ref  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.autotune import (AutotuneCache,  # noqa: E402
                                          FusedConfig, candidate_configs,
                                          tune_fused)
from repro_torch.kernels.fused import ops as f_ops  # noqa: E402

# tiny model: F*T = 32 (one packed word), bucket 8
F, T, M, N, C, BUCKET = 4, 8, 10, 3, 5, 8
SPEC_FP = "cafef00dcafef00d"


class FakeTimer:
    """Deterministic clock: call i advances by deltas[i] seconds (1 s past
    the script).  ``time_step`` with iters=1 brackets each candidate's
    timed run with two calls, so the measured time is the delta at the
    first of them."""

    def __init__(self, deltas):
        self._deltas = list(deltas)
        self._t = 0.0
        self.calls = 0

    def __call__(self):
        now = self._t
        self._t += (self._deltas[self.calls]
                    if self.calls < len(self._deltas) else 1.0)
        self.calls += 1
        return now


@pytest.fixture
def model():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (BUCKET, F)).astype(np.float32)
    th = np.sort(rng.uniform(-1, 1, (F, T)).astype(np.float32), 1)
    mapping = rng.integers(0, F * T, (M, N)).astype(np.int32)
    tables = rng.integers(0, 2, (M, 2 ** N)).astype(np.int32)
    return x, th, mapping, tables


CANDS = [FusedConfig(variant="packed", block_b=32),
         FusedConfig(variant="batch-major", block_b=32)]
# per candidate (iters=1): t0, timed run, t1 -> batch-major (5 us) beats
# packed (50 us)
DELTAS = [50e-6, 1e-6, 5e-6, 1e-6]


def _tune(model, cache, timer, **kw):
    x, th, mapping, tables = model
    return tune_fused(torch.from_numpy(th), [torch.from_numpy(mapping)],
                      [torch.from_numpy(tables)], C, x,
                      spec_fingerprint=SPEC_FP, cache=cache,
                      candidates=kw.pop("candidates", CANDS), iters=1,
                      timer=timer, **kw)


def test_tuner_deterministic_under_stubbed_clock(tmp_path, model):
    """Same scripted timings -> same winner, twice over."""
    winners = []
    for run in range(2):
        cache = AutotuneCache(tmp_path / f"cache{run}.json")
        winners.append(_tune(model, cache, FakeTimer(DELTAS)))
    assert winners[0] == winners[1] == CANDS[1]


def test_cache_hit_skips_timing(tmp_path, model):
    """A fresh cache object on the same file serves the winner without a
    tick of the clock; ``force=True`` times again."""
    cache = AutotuneCache(tmp_path / "cache.json")
    assert _tune(model, cache, FakeTimer(DELTAS)) == CANDS[1]
    timer = FakeTimer(DELTAS)
    assert _tune(model, AutotuneCache(cache.path), timer) == CANDS[1]
    assert timer.calls == 0
    timer = FakeTimer(DELTAS)
    assert _tune(model, AutotuneCache(cache.path), timer,
                 force=True) == CANDS[1]
    assert timer.calls == 4


def test_cache_invalidated_on_kernel_source_change(tmp_path, model,
                                                   monkeypatch):
    """A changed kernel fingerprint misses and times again."""
    cache = AutotuneCache(tmp_path / "cache.json")
    _tune(model, cache, FakeTimer(DELTAS))
    assert AutotuneCache(cache.path).get(SPEC_FP, BUCKET, "cpu") == CANDS[1]
    monkeypatch.setattr(autotune, "kernel_fingerprint",
                        lambda: "0badc0de0badc0de")
    assert AutotuneCache(cache.path).get(SPEC_FP, BUCKET, "cpu") is None
    timer = FakeTimer(DELTAS)
    assert _tune(model, AutotuneCache(cache.path), timer) == CANDS[1]
    assert timer.calls > 0


def test_kernel_fingerprint_covers_the_kernel_sources(monkeypatch):
    """The fingerprint hashes the CUDA source, the wrappers and the bit
    format, so an edit to any of them changes it."""
    fp = autotune.kernel_fingerprint()
    assert len(fp) == 16 and fp == autotune.kernel_fingerprint()
    read = autotune.Path.read_bytes

    def edited(path):
        data = read(path)
        return data + b"//" if path.name == "fused_dwn.cu" else data
    monkeypatch.setattr(autotune.Path, "read_bytes", edited)
    autotune.kernel_fingerprint.cache_clear()
    try:
        assert autotune.kernel_fingerprint() != fp
    finally:
        monkeypatch.undo()
        autotune.kernel_fingerprint.cache_clear()
    assert autotune.kernel_fingerprint() == fp


def test_cold_start_absent_and_corrupt_cache(tmp_path, model):
    """An absent file misses and is written by the tune; corrupt files
    (not JSON, the wrong shape) miss and are overwritten cleanly."""
    cache = AutotuneCache(tmp_path / "nope.json")
    assert cache.get(SPEC_FP, BUCKET, "cpu") is None
    assert _tune(model, cache, FakeTimer(DELTAS)) == CANDS[1]
    assert cache.path.exists()
    for i, text in enumerate(("{not json", "[1, 2]",
                              '{"entries": {"k": 3}}')):
        bad = tmp_path / f"corrupt{i}.json"
        bad.write_text(text)
        cache = AutotuneCache(bad)
        assert cache.get(SPEC_FP, BUCKET, "cpu") is None
        assert _tune(model, cache, FakeTimer(DELTAS)) == CANDS[1]
        assert json.loads(bad.read_text())["entries"]
    assert not list(tmp_path.glob("*.tmp"))


def test_cache_entry_records_timings_and_roundtrips(tmp_path, model):
    cache = AutotuneCache(tmp_path / "cache.json")
    _tune(model, cache, FakeTimer(DELTAS))
    raw = json.loads(cache.path.read_text())["entries"]
    (key, entry), = raw.items()
    assert key == autotune.cache_key(SPEC_FP, BUCKET, "cpu")
    assert entry["code"] == autotune.kernel_fingerprint()
    assert entry["timings_us"][CANDS[1].label] == pytest.approx(5.0)
    assert entry["timings_us"][CANDS[0].label] == pytest.approx(50.0)
    assert FusedConfig.from_dict(entry["config"]) == CANDS[1]


def test_default_cache_path_is_the_ports_own(tmp_path, monkeypatch):
    """``$REPRO_AUTOTUNE_CACHE`` wins; else a file under
    ``~/.cache/repro_torch``, never the reference's."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert autotune.default_cache_path() == tmp_path / "x.json"
    assert AutotuneCache().path == tmp_path / "x.json"
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    path = autotune.default_cache_path()
    assert path.is_relative_to(tmp_path / ".cache" / "repro_torch")
    assert autotune.device_kind("cpu") == "cpu"


def test_candidate_configs_cover_both_variants():
    """Both variants at every bucket; block_b 64 only where the bucket
    has more than one warp's 32 rows."""
    for bucket in (8, 32, 33, 64, 4096):
        cands = candidate_configs(bucket)
        assert {c.variant for c in cands} == set(autotune.VARIANTS)
        want = {32} if bucket <= 32 else {32, 64}
        assert {c.block_b for c in cands} == want, bucket
        assert len(cands) == 2 * len(want)


def test_refused_candidate_is_recorded_and_skipped(tmp_path, model,
                                                   monkeypatch):
    """A candidate whose wrapper refuses its operands before any launch
    (ValueError) is skipped and recorded as refused."""
    real = f_ops.make_forward_packed

    def refuse_packed(*a, config, **kw):
        if config.variant == "packed":
            raise ValueError("activations too wide for a block")
        return real(*a, config=config, **kw)
    monkeypatch.setattr(f_ops, "make_forward_packed", refuse_packed)
    cache = AutotuneCache(tmp_path / "cache.json")
    # batch-major is timed first now: the script's first delta is its time
    assert _tune(model, cache, FakeTimer([7e-6, 1e-6])) == CANDS[1]
    entry, = json.loads(cache.path.read_text())["entries"].values()
    assert entry["timings_us"] == {CANDS[0].label: "refused",
                                   CANDS[1].label: pytest.approx(7.0)}


def test_every_candidate_refused_raises(tmp_path, model, monkeypatch):
    """Where the reference falls back to its default, the port raises:
    the default config would be refused too.  Nothing is persisted."""
    def refuse(*a, **kw):
        raise ValueError("activations too wide for a block")
    monkeypatch.setattr(f_ops, "make_forward_packed", refuse)
    cache = AutotuneCache(tmp_path / "cache.json")
    with pytest.raises(ValueError, match="every fused candidate"):
        _tune(model, cache, FakeTimer(DELTAS))
    assert not cache.path.exists()


def test_a_failed_launch_is_not_skipped(tmp_path, model, monkeypatch):
    """Any error other than a refusal before the launch (a CUDA error is
    a RuntimeError) propagates out of the tuner."""
    def broken(*a, **kw):
        def fn(x):
            raise RuntimeError("fused_dwn_packed launch failed: CUDA "
                               "error 700")
        return fn
    monkeypatch.setattr(f_ops, "make_forward_packed", broken)
    cache = AutotuneCache(tmp_path / "cache.json")
    with pytest.raises(RuntimeError, match="launch failed"):
        _tune(model, cache, FakeTimer(DELTAS))
    assert not cache.path.exists()


def test_tuned_configs_stay_bit_exact(model):
    """Exact: every candidate the tuner can pick (and the default) gives
    the reference's plain fused kernel's counts and argmax."""
    x, th, mapping, tables = model
    for bucket in (BUCKET, 64):
        xb = np.resize(x, (bucket, F))
        ref_counts, ref_idx = fused_dwn_packed_ref(
            jnp.asarray(xb), jnp.asarray(th), [jnp.asarray(mapping)],
            [jnp.asarray(tables)], C)
        for cfg in [None] + candidate_configs(bucket):
            counts, idx = f_ops.forward_packed(
                torch.from_numpy(xb), torch.from_numpy(th),
                torch.from_numpy(mapping), torch.from_numpy(tables), C,
                config=cfg)
            np.testing.assert_array_equal(counts.numpy(),
                                          np.asarray(ref_counts),
                                          err_msg=str(cfg))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx),
                                          err_msg=str(cfg))
