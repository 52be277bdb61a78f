"""DWNArtifact: the spec -> serve lifecycle in one object.

The PyTorch counterpart of ``repro.dwn.artifact`` (serving stages)::

    spec ──fit/adopt──▶ trained ──freeze()──▶ frozen ──pack()──▶ packed
                                                                   │
                                                           serving_model()

* **trained** — ``params`` (LUT scores/tables) + ``buffers`` (thermometer
  thresholds fit on training features).  ``fit`` initializes without
  gradient epochs; ``adopt`` accepts state trained elsewhere, such as the
  reference's parameters carried across with
  ``core.model.params_from_numpy``.
* **frozen** — hardware semantics (``core.model.FrozenDWN``): int32 wires,
  {0,1} tables, thresholds quantized to the spec's (1, n) grid for PEN.
* **packed** — the frozen operands staged on the serving device.

Calling a stage method out of order raises :class:`LifecycleError`;
re-running an earlier stage invalidates the later ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.model import FrozenDWN, init_dwn
from ..core.model import freeze as freeze_dwn
from ..device import resolve_device
from .spec import DWNSpec

#: lifecycle stages in order.
STAGES = ("spec", "trained", "frozen", "packed")


class LifecycleError(RuntimeError):
    """A stage method was called before its prerequisite stage."""


@dataclasses.dataclass
class PackedOperands:
    """Frozen operands staged on ``device``: thresholds (F, T) float32,
    per-layer mapping (m, n) int32 and binary tables (m, 2^n) int32."""

    device: torch.device
    thresholds: torch.Tensor
    mappings: list
    tables: list


@dataclasses.dataclass
class DWNArtifact:
    """Lifecycle state for one :class:`~repro_torch.dwn.spec.DWNSpec`."""

    spec: DWNSpec
    params: dict | None = None
    buffers: dict | None = None
    frozen: FrozenDWN | None = None
    packed: PackedOperands | None = None

    @property
    def stage(self) -> str:
        if self.packed is not None:
            return "packed"
        if self.frozen is not None:
            return "frozen"
        if self.params is not None:
            return "trained"
        return "spec"

    def _require(self, stage: str, method: str, hint: str) -> None:
        if STAGES.index(self.stage) < STAGES.index(stage):
            raise LifecycleError(
                f"{method}() needs the artifact at stage {stage!r} but it "
                f"is at {self.stage!r} ({self.spec.label}); call {hint} "
                f"first")

    def _invalidate_downstream(self) -> None:
        self.frozen = None
        self.packed = None

    def fit(self, x_train: np.ndarray, *, seed: int = 0) -> "DWNArtifact":
        """Fit thresholds on ``x_train`` and initialize the LUT parameters
        from ``torch.Generator().manual_seed(seed)``, without gradient
        epochs.

        The thresholds equal the reference's for the same rows, but the
        LUT parameters do not: torch's generator draws other numbers than
        ``jax.random``, so ``fit(seed=0)`` here is another model than the
        reference's ``fit(seed=0)``.  :meth:`adopt` the reference's
        parameters to serve the same model.
        """
        gen = torch.Generator().manual_seed(seed)
        self.params, self.buffers = init_dwn(gen, self.spec.dwn_config(),
                                             x_train)
        self._invalidate_downstream()
        return self

    def adopt(self, params, buffers) -> "DWNArtifact":
        """Adopt externally trained state (port params and buffers)."""
        self.params, self.buffers = params, buffers
        self._invalidate_downstream()
        return self

    def freeze(self) -> "DWNArtifact":
        """Freeze to hardware semantics; PEN specs quantize thresholds to
        the spec's (1, n) fixed-point grid."""
        self._require("trained", "freeze", "fit()/adopt()")
        self.frozen = freeze_dwn(self.params, self.buffers,
                                 self.spec.dwn_config(),
                                 input_frac_bits=self.spec.frac_bits)
        self.packed = None
        return self

    def pack(self, device=None) -> "DWNArtifact":
        """Stage the frozen operands on ``device`` (default ``cuda``; raises
        without a card).  Idempotent per device."""
        self._require("frozen", "pack", "freeze()")
        dev = resolve_device(device)
        if self.packed is None or self.packed.device != dev:
            f = self.frozen
            self.packed = PackedOperands(
                device=dev,
                thresholds=torch.as_tensor(f.thresholds,
                                           dtype=torch.float32, device=dev),
                mappings=[torch.as_tensor(np.asarray(i, np.int32),
                                          device=dev)
                          for i in f.mapping_idx],
                tables=[torch.as_tensor(np.asarray(t, np.int32), device=dev)
                        for t in f.tables_bin])
        return self

    def serving_model(self, name: str | None = None):
        """The staged :class:`~repro_torch.serving.backends.DWNModelBundle`
        every serving backend reads from."""
        self._require("packed", "serving_model", "pack()")
        from ..serving.backends import DWNModelBundle
        p = self.packed
        return DWNModelBundle(
            name=name or self.spec.label, dcfg=self.spec.dwn_config(),
            frozen=self.frozen, device=p.device, thresholds=p.thresholds,
            mappings=p.mappings, tables=p.tables)


__all__ = ["DWNArtifact", "LifecycleError", "PackedOperands", "STAGES"]
