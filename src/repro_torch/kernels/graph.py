"""One step captured in a CUDA graph and replayed: the PyTorch counterpart
of the reference's one ``jax.jit`` executable per batch bucket.

A step of the served datapath is one or two kernel launches behind a
wrapper whose Python costs more host time than the kernels take on the
card.  :class:`CapturedStep` runs the step once eagerly (the warmup:
operand preparation, the kernels' build), captures it into a
``torch.cuda.CUDAGraph`` with a static input buffer, and on every later
call copies the rows in and replays the graph.

The graph's outputs are static: each replay overwrites them, so a caller
copies them out (or uses them) before the next call of the same step.
The launches the wrappers made during the capture are counted on every
replay (``_launch.recording``), so the launch counters stay true.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import _launch


class CapturedStep:
    """``fn(x)`` on the CUDA ``device`` as a CUDA graph replay.

    The first call warms ``fn`` up on a side stream and captures it on
    the rows it is given; each call (the first included) copies ``x``
    (host or device rows, the captured shape) into the static float32
    input on ``device`` and replays.  A capture that fails raises;
    nothing falls back to eager calls.

    Attributes:
      launches: the kernel launches one replay makes, as
        ``{kernel name: count}`` (empty before the capture).
    """

    def __init__(self, fn: Callable, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph captures a step on a CUDA "
                             f"device, not {self.device}")
        self._fn = fn
        self._graph: torch.cuda.CUDAGraph | None = None
        self._x: torch.Tensor | None = None
        self._out = None
        self._launches: list = []

    @property
    def launches(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for _, name, n in self._launches:
            out[name] = out.get(name, 0) + n
        return out

    def _capture(self, x: torch.Tensor) -> None:
        dev = self.device
        self._x = torch.empty(tuple(x.shape), dtype=torch.float32,
                              device=dev)
        self._x.copy_(x)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fn(self._x)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _launch.recording() as launches:
            with torch.cuda.graph(graph):
                self._out = self._fn(self._x)
        self._graph, self._launches = graph, launches

    def __call__(self, x: torch.Tensor):
        if self._graph is None:
            self._capture(x)
        else:
            self._x.copy_(x)
        self._graph.replay()
        _launch.replay(self._launches)
        return self._out


__all__ = ["CapturedStep"]
