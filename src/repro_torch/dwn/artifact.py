"""DWNArtifact: the spec -> serve lifecycle in one object.

The PyTorch counterpart of ``repro.dwn.artifact`` (training and serving
stages)::

    spec ──fit/train/adopt──▶ trained ──freeze()──▶ frozen ──pack()──▶ packed
                                                                        │
                                                                serving_model()

* **trained** — ``params`` (LUT scores/tables) + ``buffers`` (thermometer
  thresholds fit on training features).  ``fit`` initializes without
  gradient epochs; ``train`` runs the paper-protocol trainer
  (``core.training.train_dwn``); ``adopt`` accepts state trained
  elsewhere, such as the reference's parameters carried across with
  ``core.model.params_from_numpy``.
* **frozen** — hardware semantics (``core.model.FrozenDWN``): int32 wires,
  {0,1} tables, thresholds quantized to the spec's (1, n) grid for PEN.
* **packed** — the frozen operands staged on the serving device.

``save``/``load`` ride on ``runtime.checkpoint`` (atomic commit, sha256
per leaf) on the reference's on-disk layout, with the spec in the
manifest: an artifact saved by either package loads in the other, and a
reloaded artifact serves the saved model's outputs bit for bit.

Calling a stage method out of order raises :class:`LifecycleError`;
re-running an earlier stage invalidates the later ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any

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
    """Lifecycle state for one :class:`~repro_torch.dwn.spec.DWNSpec`.

    Attributes:
      spec: the validated build point.
      params / buffers: LUT state and thermometer thresholds.
      frozen: the hardware-semantics model (after :meth:`freeze`).
      packed: the operands staged on a device (after :meth:`pack`).
      calibration: provenance of the trained state (seed, epochs, fit
        sample count, soft accuracy when trained; what trained it), as
        the reference records it; it rides in checkpoints.
      history: per-epoch training history (loss / accuracy rows).
    """

    spec: DWNSpec
    params: dict | None = None
    buffers: dict | None = None
    frozen: FrozenDWN | None = None
    packed: PackedOperands | None = None
    calibration: dict = dataclasses.field(default_factory=dict)
    history: list = dataclasses.field(default_factory=list)

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

    def fit(self, x_train: np.ndarray, *, seed: int = 0,
            warmstart: bool = False, y_train: np.ndarray | None = None
            ) -> "DWNArtifact":
        """Fit thresholds on ``x_train`` and initialize the LUT parameters
        from ``torch.Generator().manual_seed(seed)``, without gradient
        epochs; ``warmstart=True`` uses the correlation warm start
        (``core.warmstart``; needs ``y_train``).

        The thresholds equal the reference's for the same rows, but the
        LUT parameters do not: torch's generator draws other numbers than
        ``jax.random``, so ``fit(seed=0)`` here is another model than the
        reference's ``fit(seed=0)``.  :meth:`adopt` the reference's
        parameters to serve the same model.
        """
        cfg = self.spec.dwn_config()
        gen = torch.Generator().manual_seed(seed)
        if warmstart:
            if y_train is None:
                raise ValueError("fit(warmstart=True) needs y_train for "
                                 "the correlation warm start")
            from ..core.warmstart import warmstart_dwn
            self.params, self.buffers = warmstart_dwn(gen, cfg, x_train,
                                                      y_train)
        else:
            self.params, self.buffers = init_dwn(gen, cfg, x_train)
        self.calibration = {"seed": seed, "epochs": 0,
                            "warmstart": bool(warmstart),
                            "n_fit": int(np.asarray(x_train).shape[0])}
        self.history = []
        self._invalidate_downstream()
        return self

    def train(self, data, *, epochs: int, batch: int = 128,
              lr: float = 1e-3, seed: int = 0, warmstart: bool = False,
              eval_every: int = 0, verbose: bool = False,
              device=None) -> "DWNArtifact":
        """Train on ``data`` with the paper-protocol trainer.

        Args:
          data: a split (``x_train`` / ``y_train`` / ``x_test`` /
            ``y_test``), e.g. ``data.jsc.load_jsc``.
          epochs: gradient epochs; 0 is :meth:`fit` alone.
          batch / lr / seed: the protocol's training shape.
          warmstart: the correlation warm start before training.
          eval_every: eval cadence (0: after the last epoch only).
          verbose: per-epoch prints.
          device: where to train (default ``cuda``; raises without a
            card); the trained state stays there.

        Returns self (stage "trained"); later stages are invalidated.
        """
        if self.params is None:
            self.fit(data.x_train, seed=seed, warmstart=warmstart,
                     y_train=data.y_train)
        if epochs > 0:
            from ..core.training import train_dwn
            res = train_dwn(self.spec.dwn_config(), data, epochs=epochs,
                            batch=batch, lr=lr, seed=seed,
                            params=self.params, buffers=self.buffers,
                            eval_every=eval_every, verbose=verbose,
                            device=device)
            self.params, self.buffers = res.params, res.buffers
            self.history = list(res.history)
            self.calibration.update(
                epochs=epochs, batch=batch, lr=lr,
                soft_test_acc=round(float(res.soft_test_acc), 4))
        self._invalidate_downstream()
        return self

    def adopt(self, params, buffers, *, note: str = "external"
              ) -> "DWNArtifact":
        """Adopt externally trained state (port params and buffers)."""
        self.params, self.buffers = params, buffers
        self.calibration.setdefault("trained_by", note)
        self.history = []
        self._invalidate_downstream()
        return self

    def freeze(self) -> "DWNArtifact":
        """Freeze to hardware semantics; PEN specs quantize thresholds to
        the spec's (1, n) fixed-point grid."""
        self._require("trained", "freeze", "train()/fit()/adopt()")
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

    # -- persistence ---------------------------------------------------

    def save(self, directory, *, step: int = 0):
        """Checkpoint the artifact (``runtime.checkpoint.save_artifact``);
        returns the checkpoint path."""
        from ..runtime.checkpoint import save_artifact
        return save_artifact(directory, self, step=step)

    @classmethod
    def load(cls, directory, *, step: int | None = None,
             device=None) -> "DWNArtifact":
        """Restore an artifact that either package saved; one saved at
        stage "packed" is staged again on ``device`` (default ``cuda``)."""
        from ..runtime.checkpoint import load_artifact
        return load_artifact(directory, step=step, device=device)

    def summary(self) -> dict[str, Any]:
        """JSON-able one-glance description (spec, stage, calibration)."""
        return {"spec": self.spec.to_dict(),
                "fingerprint": self.spec.fingerprint(),
                "stage": self.stage, "calibration": dict(self.calibration)}


__all__ = ["DWNArtifact", "LifecycleError", "PackedOperands", "STAGES"]
