"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` compiles on its own into a shared library
with a plain C interface under ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of its sources and flags, so an edit
rebuilds and an unchanged source is reused.  Nothing is built when a
module is imported: :func:`load` builds on the first launch of a kernel,
and :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel library name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    """Path of ``nvcc``; raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return found


def library_path(src: Path) -> Path:
    """Where ``src`` builds to: keyed by the bytes of every source in its
    directory and by the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(src.parent.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile the named kernel libraries (default: all) in parallel.

    Returns name -> {"path", "seconds", "cached", "ptxas"}: ``ptxas`` holds
    the assembler's register, shared-memory, spill and warning lines, kept
    beside the library so that a cached build reports them too.  Raises
    ``RuntimeError`` with the compiler's output if a build fails.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        src = srcs[name]
        out = library_path(src)
        kept = _ptxas_log(out)
        if out.exists() and kept.exists():
            results[name] = {"path": str(out), "seconds": 0.0,
                             "cached": True,
                             "ptxas": kept.read_text().splitlines()}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        ptxas = [line.strip() for line in log.splitlines()
                 if "ptxas" in line or "spill" in line]
        _ptxas_log(out).write_text("\n".join(ptxas))
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": round(seconds, 3),
                         "cached": False, "ptxas": ptxas}
    return results


def _ptxas_log(lib: Path) -> Path:
    return lib.with_suffix(".ptxas")


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _LIBS:
        path = build_all([name])[name]["path"]
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]


__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "library_path", "load",
           "nvcc", "sources"]
