"""Port vs reference: the hand-written Adam (``optim/adam.py``) and the
learning-rate schedules (``optim/schedule.py``).

Adam's moments and parameters after ten steps are held within 1e-5 of
each leaf's largest magnitude (float32 ``pow`` and ``sqrt`` may round
otherwise on the two libraries); the step counters are equal integers;
the schedules are equal float32 values at every probed step, epoch
boundaries included, except that warmup-cosine's float32 ``cos`` is
torch's and XLA's own, which round one unit in the last place apart on
some steps, so that schedule is held within 2 units (3e-7 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adam as jadam  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402

TOL = 1e-5


def _within(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("weight_decay,clamp,sched", [
    (0.0, (-1.0, 1.0), "steplr"), (0.01, None, "constant"),
    (0.0, (-0.05, 0.05), "cosine")])
def test_ten_adam_steps_match_reference(weight_decay, clamp, sched):
    """Within 1e-5 of each leaf's largest value: ten steps of the
    reference's Adam and the port's on the same params and gradients
    (a tree of two layers), the clamp and decoupled decay included."""
    rng = np.random.default_rng(0)
    shapes = [(7, 3, 20), (7, 8), (5, 2, 7), (5, 4)]
    params = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 10.0 ** -k, s).astype(np.float32)
              for k, s in enumerate(shapes)] for _ in range(10)]
    lr_j, lr_t = {
        "steplr": (jsched.step_lr(1e-2, 30, 0.1, 1),
                   tsched.step_lr(1e-2, 30, 0.1, 1)),
        "constant": (jsched.constant(1e-2), tsched.constant(1e-2)),
        "cosine": (jsched.warmup_cosine(1e-2, 3, 10),
                   tsched.warmup_cosine(1e-2, 3, 10))}[sched]
    opt_j = jadam.Adam(lr=lr_j, weight_decay=weight_decay, clamp=clamp)
    opt_t = tadam.Adam(lr=lr_t, weight_decay=weight_decay, clamp=clamp)

    def tree(leaves):
        return {"layers": [{"scores": leaves[0], "tables": leaves[1]},
                           {"scores": leaves[2], "tables": leaves[3]}]}

    pj = tree([jnp.asarray(p) for p in params])
    sj = opt_j.init(pj)
    pt = tree([torch.from_numpy(p.copy()) for p in params])
    st = opt_t.init(pt)
    for g in grads:
        pj, sj = opt_j.update(tree([jnp.asarray(x) for x in g]), sj, pj)
        opt_t.update(tree([torch.from_numpy(x) for x in g]), st, pt)
    assert st.step.dtype == torch.int32 and int(st.step) == int(sj.step)
    for got, want in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
        for a, b in zip(tadam.leaves(got), jax.tree.leaves(want)):
            _within(a.numpy(), b)
    if clamp is not None:
        for a in tadam.leaves(pt):
            assert np.float32(clamp[0]) <= a.min().numpy() and \
                a.max().numpy() <= np.float32(clamp[1])


def test_adam_counts_steps_on_the_params_device_in_int32():
    """Exact: the counter starts at 0 on the parameters' device, in
    int32, and each update adds one; the moments are zeros shaped like
    the params."""
    params = {"layers": [{"scores": torch.ones(2, 3, 4),
                          "tables": torch.ones(2, 8)}]}
    opt = tadam.Adam(lr=1e-3)
    st = opt.init(params)
    assert st.step.dtype == torch.int32 and st.step.dim() == 0
    assert int(st.step) == 0
    assert all(torch.equal(m, torch.zeros_like(p)) for m, p in zip(
        tadam.leaves(st.mu), tadam.leaves(params)))
    for k in range(3):
        opt.update(tadam.map_tree(torch.ones_like, params), st, params)
        assert int(st.step) == k + 1


@pytest.mark.parametrize("name", ["step_lr", "constant", "warmup_cosine"])
def test_schedules_equal_reference_at_epoch_boundaries(name):
    """Exact (warmup-cosine within 2 units in the last place, its
    ``cos``): each schedule's float32 learning rate at the steps around
    every StepLR boundary (epochs 29-31, 59-61, 89-91 at 156 steps an
    epoch) and through warm-up, from an int32 counter and from a host
    int."""
    spe = 156
    make = {
        "step_lr": lambda m: m.step_lr(1e-3, 30, 0.1, spe),
        "constant": lambda m: m.constant(1e-3),
        "warmup_cosine": lambda m: m.warmup_cosine(1e-3, 100, 90 * spe)}[
        name]
    fj, ft = make(jsched), make(tsched)
    steps = sorted({0, 1, 50, 99, 100, 101}
                   | {e * spe + d for e in (29, 30, 31, 59, 60, 61, 89, 90)
                      for d in (-1, 0, 1)})
    for s in steps:
        want = np.float32(fj(jnp.asarray(s, jnp.int32)))
        got = ft(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        rtol = 3e-7 if name == "warmup_cosine" else 0.0
        for v in (got, ft(s)):
            assert abs(np.float32(v) - want) <= rtol * want, (s, float(v),
                                                              float(want))
    if name == "step_lr":
        assert float(ft(30 * spe - 1)) == pytest.approx(1e-3)
        assert float(ft(30 * spe)) == pytest.approx(1e-4)
