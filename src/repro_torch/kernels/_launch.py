"""What every kernel wrapper shares: operand checks, the ctypes binding of
a kernel library, the CUDA error check after a launch and the launch
counters that ``chip_smoke.py`` reads."""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from . import _build

P, I = ctypes.c_void_p, ctypes.c_int


class LaunchCounts:
    """Launches per kernel name since the last :meth:`reset`.

    A wrapper calls :meth:`add` right after its kernel launched, and
    nowhere else, so the counts show which kernels a run went through.
    The launches a wrapper makes while a CUDA graph is being captured are
    held back instead: the capture runs nothing, and every replay of the
    graph adds them (:func:`recording`, ``kernels.graph``).  Serving loops
    launch from their own threads, so a recording holds only its own
    thread's launches and the counts take a lock.
    """

    def __init__(self, *names: str):
        self._n = dict.fromkeys(names, 0)
        self._lock = threading.Lock()

    def add(self, name: str, n: int = 1) -> None:
        stack = _recording_stack()
        if stack:
            stack[-1].append((self, name, n))
        else:
            with self._lock:
                self._n[name] += n

    def get(self) -> dict[str, int]:
        with self._lock:
            return dict(self._n)

    def reset(self) -> None:
        with self._lock:
            for name in self._n:
                self._n[name] = 0


#: per thread, its open :func:`recording` blocks, innermost last: a
#: capture in one thread must not take the launches another thread's
#: replays make meanwhile
_RECORDING = threading.local()


def _recording_stack() -> list[list]:
    stack = getattr(_RECORDING, "stack", None)
    if stack is None:
        stack = _RECORDING.stack = []
    return stack


@contextlib.contextmanager
def recording():
    """Inside the block, the calling thread's launches are recorded, not
    counted (a CUDA graph capture launches nothing).  Yields the list of
    ``(counter, name, n)`` the block recorded; :func:`replay` adds them
    where the captured kernels really run."""
    launches: list = []
    stack = _recording_stack()
    stack.append(launches)
    try:
        yield launches
    finally:
        stack.pop()


def replay(launches) -> None:
    """Count the launches a :func:`recording` block took (one replay of
    the graph it captured)."""
    for counter, name, n in launches:
        counter.add(name, n)


def align16(v: int) -> int:
    """``v`` rounded up to a multiple of 16 (a shared-memory layout's
    part boundary, as ``align16`` in ``csrc/tiles.cuh``)."""
    return (v + 15) // 16 * 16


def expect(t: torch.Tensor, name: str, dtype, ndim: int,
           device: torch.device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``ndim``-d
    ``dtype`` tensor on ``device``."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the operands are on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_type(t: torch.Tensor, kernel: str) -> str:
    """``"cpu"`` or ``"cuda"``; raises ``ValueError`` for any other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on cpu or cuda tensors, got "
                         f"{t.device}")
    return t.device.type


_BOUND: dict[str, ctypes.CDLL] = {}
_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device``: the tile
    kernels' wrappers cut a launch into enough blocks to fill them."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def bind(library: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, with each
    function's argument types and an ``int`` (``cudaError_t``) result.
    Every library also exports ``<library>_error_string(int)``."""
    if library not in _BOUND:
        lib = _build.load(library)
        for fn, args in signatures.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = I
        err = getattr(lib, f"{library}_error_string")
        err.argtypes = [I]
        err.restype = ctypes.c_char_p
        _BOUND[library] = lib
    return _BOUND[library]


def launch(lib: ctypes.CDLL, library: str, name: str, device: torch.device,
           call, counts: LaunchCounts) -> None:
    """Run ``call(stream)`` (which launches kernel ``name`` and returns its
    ``cudaError_t``) on the current stream of ``device``; raise on any
    CUDA error, else count the launch."""
    with torch.cuda.device(device):
        err = call(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = getattr(lib, f"{library}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    counts.add(name)


__all__ = ["I", "LaunchCounts", "P", "align16", "bind", "device_type",
           "expect", "launch", "recording", "replay", "sm_count"]
