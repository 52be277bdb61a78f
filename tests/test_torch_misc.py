"""The port's boundaries: its own data loader copy, its import isolation
from JAX and the reference package, and entry points that refuse to run
without a card unless asked for the CPU.  Comparisons are exact."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process)

from repro.data import jsc as jjsc  # noqa: E402
from repro_torch.data import jsc as tjsc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 3])
def test_data_loader_copy_gives_identical_rows(seed):
    """Exact: the same seed gives byte-identical splits in both packages,
    also through the port's workload registry."""
    from repro_torch.workloads import get_workload, list_workloads
    ref = jjsc.load_jsc(700, 300, seed=seed)
    for got in (tjsc.load_jsc(700, 300, seed=seed),
                get_workload("jsc").load(700, 300, seed)):
        for field in ("x_train", "y_train", "x_test", "y_test"):
            a, b = getattr(got, field), getattr(ref, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert list_workloads() == ["jsc"]
    assert tjsc.bayes_accuracy(2000) == jjsc.bayes_accuracy(2000)


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch imports in a fresh interpreter without
    pulling in jax or any module of repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.')]\n"
        "assert len(names) > 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no CPU request, the engine, the artifact's pack,
    and the serve CLI raise; they never fall back to the CPU."""
    from repro_torch.dwn import DWNArtifact, get_spec
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine("dwn-jsc-sm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine("dwn-jsc-sm", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "dwn-jsc-sm", "--reduced"])
    art = DWNArtifact(get_spec("dwn-jsc-sm"))
    art.fit(tjsc.load_jsc(300, 10).x_train).freeze()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        art.pack()
    assert art.pack("cpu").stage == "packed"


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    """The LM engine (by name and by config) and ``--arch qwen3-8b`` raise
    with no card and no CPU request, before building a parameter."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_arch("qwen3-8b"), attn_impl="pallas")
    for arch in ("qwen3-8b", cfg):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(arch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-8b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-8b", "--reduced", "--batch", "2"])


def test_chip_smoke_refuses_to_run_without_a_card_or_the_port(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and in a directory that holds only the script."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = ROOT / "chip_smoke.py"
    for where in (ROOT, tmp_path):
        if where is tmp_path:
            shutil.copy(script, tmp_path / "chip_smoke.py")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_kernel_build_is_deferred_to_first_launch():
    """Importing the kernels builds nothing; the library is keyed by its
    sources and sits under build/ in the checkout."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused import kernel  # noqa: F401
    import repro_torch.kernels.flash_attn.ops  # noqa: F401
    import repro_torch.kernels.lut_eval.ops  # noqa: F401
    import repro_torch.kernels.popcount.ops  # noqa: F401
    import repro_torch.kernels.thermometer.ops  # noqa: F401
    assert not _build._LIBS
    srcs = _build.sources()
    assert list(srcs) == ["flash_attn", "fused_dwn", "lut_eval", "popcount",
                          "thermometer"]
    path = _build.library_path(srcs["fused_dwn"])
    assert path.parent == ROOT / "build" / "repro_torch_kernels"
    assert path.name.startswith("libfused_dwn-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_cached_build_reports_its_ptxas_lines(tmp_path, monkeypatch):
    """A library reused from the build cache reports the assembler's
    lines it was compiled with, so a check of spills still sees them (a
    stand-in for nvcc writes the library and prints the lines)."""
    from repro_torch.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n'
                    'echo "ptxas info    : Used 40 registers"\n'
                    'echo "0 bytes stack frame, 0 bytes spill stores, '
                    '0 bytes spill loads"\n'
                    'echo "unrelated"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build_all(["popcount"])["popcount"]
    again = _build.build_all(["popcount"])["popcount"]
    assert not first["cached"] and again["cached"]
    assert first["ptxas"] == again["ptxas"] == [
        "ptxas info    : Used 40 registers",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]
    assert Path(again["path"]).parent == tmp_path / "build"
