"""The port's open-loop load generator and its serving CLIs, held to the
reference's.

* ``make_arrivals`` gives the reference's schedule bit for bit (stationary
  Poisson, burst windows, a three-tenant mix of fixed and uniform sizes);
* ``_metrics`` equals the reference's on scripted requests;
* ``python -m repro_torch.launch.loadgen`` and ``python -m
  repro_torch.launch.serve --continuous`` run on the CPU and exit 0; the
  load generator prints the reference's keys and accounts for every
  arrival (served + shed + rejected = offered);
* the argparse options of both CLIs have the reference's names and
  defaults, apart from the port's own ``--device`` and
  ``--slo-queue-samples``.

The port's load generator CLI differs from the reference's in one
repaired fault: it takes the mean request size from 256 draws of one
generator, where the reference draws each from a new generator
(``src/repro/launch/loadgen.py:350``) and so divides by the first draw.

No assertion reads a latency or the wall clock.
"""

import argparse
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import loadgen as jloadgen  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import loadgen as tloadgen  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_ONLY = {"device", "slo_queue_samples"}


def _spec(mod, case):
    if case == "poisson":
        return mod.LoadSpec(rate_rps=700.0, duration_s=1.5, seed=4)
    if case == "bursts":
        return mod.LoadSpec(rate_rps=500.0, duration_s=2.0, seed=42,
                            burst_factor=3.0, burst_every_s=1.0,
                            burst_len_s=0.25)
    tenants = (
        mod.Tenant(name="rt", weight=3.0, size="fixed:16",
                   deadline_ms=10.0, priority=1, preset="sm"),
        mod.Tenant(name="batch", weight=1.0, size="uniform:32:64",
                   deadline_ms=None, priority=0, preset="md"),
        mod.Tenant(name="bulk", weight=0.5, size="uniform:256:4096",
                   deadline_ms=5.0, priority=2, preset=None),
    )
    return mod.LoadSpec(rate_rps=1000.0, duration_s=2.0, seed=11,
                        burst_factor=4.0, burst_every_s=0.5,
                        burst_len_s=0.1, tenants=tenants)


@pytest.mark.parametrize("case", ["poisson", "bursts", "three_tenants"])
def test_make_arrivals_equals_the_reference_bit_for_bit(case):
    """Exact: every arrival's time (float bits), size, tenant, deadline,
    priority and preset."""
    got = [tuple(vars(a).values())
           for a in tloadgen.make_arrivals(_spec(tloadgen, case))]
    want = [tuple(vars(a).values())
            for a in jloadgen.make_arrivals(_spec(jloadgen, case))]
    assert len(got) > 500
    assert got == want
    if case == "three_tenants":
        assert {a[2] for a in got} == {"rt", "batch", "bulk"}


def test_tenant_size_spec_refused_like_the_reference():
    for mod in (tloadgen, jloadgen):
        with pytest.raises(ValueError, match="unknown size distribution"):
            mod.Tenant(size="gamma:1:2").sample_size(
                np.random.default_rng(0))


def _scripted(mod):
    """Arrivals with a served, a late-shed, an expired, a rejected (None)
    and a sync (no ``shed`` attribute) request, and lateness values."""
    arrivals = [mod.Arrival(t=0.01 * (i + 1), size=16 * (i + 1),
                            tenant="default", deadline_ms=5.0, priority=0,
                            preset=None) for i in range(7)]
    t0 = 100.0
    reqs = [types.SimpleNamespace(shed=None, t_done=t0 + 0.0131),
            types.SimpleNamespace(shed="late", t_done=t0 + 0.06),
            None,
            types.SimpleNamespace(shed="expired", t_done=0.0),
            types.SimpleNamespace(t_done=t0 + 0.0523),
            types.SimpleNamespace(shed=None, t_done=t0 + 0.0911),
            types.SimpleNamespace(shed="admission", t_done=0.0)]
    return list(zip(arrivals, reqs)), t0


@pytest.mark.parametrize("lateness", [[], [1e-4, 3e-3, 0.0, 2.5e-4]])
def test_metrics_equal_the_reference(lateness):
    """Exact: the per-level metrics of scripted requests."""
    out = {}
    for name, mod in (("port", tloadgen), ("reference", jloadgen)):
        reqs, t0 = _scripted(mod)
        out[name] = mod._metrics(reqs, t0, t0 + 0.2, rejected=1,
                                 lateness_s=lateness)
    assert out["port"] == out["reference"]
    assert out["port"]["served_requests"] == 3
    assert out["port"]["shed_requests"] == 4


def _reference_metric_keys():
    reqs, t0 = _scripted(jloadgen)
    return set(jloadgen._metrics(reqs, t0, t0 + 0.2, rejected=1,
                                 lateness_s=[1e-4]))


def _run(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    out = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def test_loadgen_cli_runs_on_the_cpu(tmp_path):
    """``--preset dwn-jsc-sm --device cpu --max-bucket 32 --levels 0.5
    --duration 0.3 --mode both`` exits 0 and prints one level with the
    reference's keys, every arrival served, shed or rejected in both
    modes."""
    curve = tmp_path / "curve.json"
    (level,) = _run(["repro_torch.launch.loadgen", "--preset", "dwn-jsc-sm",
                     "--device", "cpu", "--max-bucket", "32", "--levels",
                     "0.5", "--duration", "0.3", "--mode", "both",
                     "--out", str(curve)], tmp_path)
    assert set(level) == {"rate_rps", "arrivals", "duration_s",
                          "continuous", "sync", "load_fraction"}
    assert level["load_fraction"] == 0.5 and level["arrivals"] > 0
    # the offered rate is the fraction of capacity over the mean of 256
    # draws of one generator (uniform:32:256 -> 148.79 rows)
    cap = json.loads(curve.read_text())["capacity_samples_per_s"]
    assert level["rate_rps"] == pytest.approx(
        0.5 * cap["dwn-jsc-sm"] / 148.7890625, abs=0.2)
    keys = _reference_metric_keys()
    for mode in ("continuous", "sync"):
        m = level[mode]
        assert set(m) <= keys
        assert keys - set(m) <= {"latency_ms_p50", "latency_ms_p99",
                                 "latency_ms_p999"}
        assert m["served_requests"] + m["shed_requests"] == \
            level["arrivals"]
        assert m["rejected_requests"] <= m["shed_requests"]
    assert level["sync"]["shed_requests"] == 0


def test_serve_cli_continuous_runs_on_the_cpu(tmp_path):
    """``--arch dwn-jsc-sm --device cpu --continuous --deadline-ms 50``
    exits 0; the report accounts for every request as served or shed."""
    (rep,) = _run(["repro_torch.launch.serve", "--arch", "dwn-jsc-sm",
                   "--device", "cpu", "--continuous", "--deadline-ms", "50"],
                  tmp_path)
    assert rep["continuous"] is True and rep["device"] == "cpu"
    assert rep["requests"] + rep["shed"]["requests"] == 64
    assert rep["async"]["served_requests"] == rep["requests"]
    assert {"latency_ms_p50", "latency_ms_p99", "straggler"} <= set(rep)


class _Parsed(Exception):
    pass


def _options(main, monkeypatch):
    """{dest: default} of the parser ``main`` builds (stopped at
    ``parse_args``, before anything runs)."""
    def stop(parser, *args, **kwargs):
        raise _Parsed(parser)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as info:
        main([])
    parser = info.value.args[0]
    return {a.dest: a.default for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("cli", ["loadgen", "serve"])
def test_cli_options_match_the_reference(cli, monkeypatch):
    """Every option of the reference's CLI exists in the port's with the
    same default; the port adds only ``--device`` and
    ``--slo-queue-samples``."""
    port_main, ref_main = {"loadgen": (tloadgen.main, jloadgen.main),
                           "serve": (tserve.main, jserve.main)}[cli]
    port, ref = _options(port_main, monkeypatch), _options(ref_main,
                                                           monkeypatch)
    assert set(port) - set(ref) <= PORT_ONLY
    assert {k: port[k] for k in ref} == ref
