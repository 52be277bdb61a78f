"""DWN training engine: the minibatch step as one CUDA graph replay.

The PyTorch counterpart of ``repro.training.engine``.  The reference runs
an epoch block as one ``lax.scan`` program with donated state and fetches
the losses once per block.  Here:

* the training split is thermometer-encoded **once** (uint8 bit rows, on
  the device) and ``loss_fn_from_bits`` reads gathered rows;
* a :class:`StepProgram` owns static buffers (parameters, Adam moments
  and step counter, the encoded split, labels, the epoch's permutation, a
  step index and the epoch's losses, all on the device) and one minibatch
  step over them: gather the rows at the step index, forward, backward,
  Adam in place, write the loss, advance the index.  On CUDA that step is
  captured once as a CUDA graph and every step of an epoch is a replay;
  the host makes no sync inside an epoch block and fetches the block's
  losses once.  On the CPU the same step runs eagerly;
* the StepLR schedule reads Adam's int32 step counter on the device;
* the programs are cached process-wide by (cfg, split size, bits, batch,
  lr, schedule, device), as the reference caches its compiled programs:
  a trainer copies its state into the program's buffers before a block
  and back after it, so trainers of one shape share one captured graph.

Batch order matches ``repro_torch.data.jsc.batches``: each epoch's
permutation comes from the same ``SeedSequence([seed, epoch])`` stream as
the reference's, drawn by numpy on the host.

A capture that fails raises; nothing falls back to eager steps.  The
eager step stays beside the graph (:meth:`StepProgram.step` with
``eager=True``) for the check that a replay equals it.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..core.model import DWNConfig, init_dwn, loss_fn_from_bits
from ..core.thermometer import encode, quantize_fixed_point
from ..device import resolve_device
from ..optim.adam import Adam, leaves, map_tree
from ..optim.schedule import constant, step_lr


def epoch_permutation(n: int, steps: int, batch: int, *, seed: int,
                      epoch: int) -> np.ndarray:
    """The (steps*batch,) sample order of one epoch: byte-identical to the
    order ``data.jsc.batches`` yields (drop-remainder)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n)[:steps * batch].astype(np.int32)


def encode_dataset(x: np.ndarray, thresholds: torch.Tensor, *,
                   input_frac_bits: int | None = None) -> torch.Tensor:
    """Thermometer-encode a whole split once: (N, F) -> (N, F*T) uint8 on
    the thresholds' device, PEN features quantized first."""
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        thresholds.device)
    if input_frac_bits is not None:
        xd = quantize_fixed_point(xd, input_frac_bits)
    return encode(xd, thresholds).to(torch.uint8)


@contextlib.contextmanager
def full_float32():
    """float32 matrix products in full float32, not TF32, inside the
    block, whatever the caller has set; restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def make_optimizer(lr: float, sched: str, steps_per_epoch: int) -> Adam:
    """The paper protocol's Adam: StepLR(30, 0.1) over epochs (or a
    constant rate), parameters clamped to [-1, 1]."""
    if sched not in ("steplr", "constant"):
        raise ValueError(f"unknown schedule {sched!r}; choose 'steplr' or "
                         f"'constant'")
    schedule = (step_lr(lr, 30, 0.1, max(1, steps_per_epoch))
                if sched == "steplr" else constant(lr))
    return Adam(lr=schedule, clamp=(-1.0, 1.0))


class StepProgram:
    """One minibatch step of the paper protocol over static buffers.

    Args:
      cfg: model config (fixes the parameter shapes).
      n / num_bits: rows and bits of the encoded training split.
      batch / lr / sched: the protocol's knobs.
      device: where the buffers live; on CUDA the step is captured as a
        CUDA graph at the first :meth:`load` and replayed after.

    Attributes:
      steps: minibatch steps per epoch (drop-remainder).
      opt: the Adam the step applies.
      params / opt_state: the static parameters and optimizer state.
      losses: (steps,) float32, the current epoch's per-step losses.
    """

    def __init__(self, cfg: DWNConfig, n: int, num_bits: int, batch: int,
                 lr: float, sched: str, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.steps, self.batch = n // batch, batch
        self.opt = make_optimizer(lr, sched, self.steps)
        dev = self.device
        specs = cfg.layer_specs()
        if specs[0].num_candidates != num_bits:
            raise ValueError(f"{num_bits} bits a row; {cfg} reads "
                             f"{specs[0].num_candidates}")
        self.params = {"layers": [
            {"scores": torch.zeros((s.num_luts, s.fan_in, s.num_candidates),
                                   device=dev).requires_grad_(),
             "tables": torch.zeros((s.num_luts, s.table_size),
                                   device=dev).requires_grad_()}
            for s in specs]}
        self._leaves = leaves(self.params)
        self.opt_state = self.opt.init(self.params)
        self.bits = torch.zeros((n, num_bits), dtype=torch.uint8, device=dev)
        self.y = torch.zeros(n, dtype=torch.int64, device=dev)
        self.perm = torch.zeros((self.steps, batch), dtype=torch.int64,
                                device=dev)
        self.step_idx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.losses = torch.zeros(self.steps, dtype=torch.float32,
                                  device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None

    # -- state in and out ----------------------------------------------

    @torch.no_grad()
    def load(self, params, opt_state, bits: torch.Tensor,
             y: torch.Tensor) -> None:
        """Copy a trainer's state and split into the static buffers; on
        CUDA the step is captured first (at the first load), since its
        warm-up writes them."""
        if self.device.type == "cuda" and self.graph is None \
                and self.steps:
            self._capture()
        for dst, src in zip(self._leaves + leaves(self.opt_state),
                            leaves(params) + leaves(opt_state)):
            dst.copy_(src)
        self.bits.copy_(bits)
        self.y.copy_(y)

    @torch.no_grad()
    def store(self, params, opt_state) -> None:
        """Copy the static parameters and optimizer state out."""
        for dst, src in zip(leaves(params) + leaves(opt_state),
                            self._leaves + leaves(self.opt_state)):
            dst.copy_(src)

    def begin_epoch(self, perm: torch.Tensor) -> None:
        """Set the epoch's (steps*batch,) row order (on the device) and
        rewind the step index."""
        self.perm.copy_(perm.view(self.steps, self.batch))
        self.step_idx.zero_()

    # -- the step --------------------------------------------------------

    def _step(self) -> None:
        with torch.profiler.record_function("train.gather"):
            rows = self.perm.index_select(0, self.step_idx).view(-1)
            xb = self.bits.index_select(0, rows)
            yb = self.y.index_select(0, rows)
        with torch.enable_grad():
            loss, _ = loss_fn_from_bits(self.params, self.cfg, xb, yb)
            grads = torch.autograd.grad(loss, self._leaves)
        with torch.no_grad(), torch.profiler.record_function("train.adam"):
            self.opt.update(list(grads), self.opt_state, self.params)
            self.losses.index_copy_(0, self.step_idx, loss.view(1))
            self.step_idx.add_(1)

    def _capture(self) -> None:
        """Warm the step up on a side stream (its lazy initialisations:
        cuBLAS, autograd), then capture it.  The warm-up steps write the
        static buffers, so this runs before a trainer's state is loaded;
        the step index is rewound around each.  Raises if the capture
        fails."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with full_float32():
            with torch.cuda.stream(side):
                for _ in range(3):
                    self.step_idx.zero_()
                    self._step()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.step_idx.zero_()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._step()
        self.graph = graph

    def step(self, *, eager: bool = False) -> None:
        """One minibatch step at the step index: a replay of the graph
        captured at the first :meth:`load` on CUDA, eager on the CPU or
        when ``eager``."""
        if eager or self.device.type != "cuda":
            with full_float32():
                self._step()
            return
        if self.graph is None:
            raise RuntimeError("load() a trainer's state before the first "
                               "step: the capture's warm-up writes the "
                               "static buffers")
        self.graph.replay()

    def run(self, params, opt_state, bits: torch.Tensor, y: torch.Tensor,
            perms: np.ndarray) -> np.ndarray:
        """Train ``params`` and ``opt_state`` (updated in place) for one
        epoch per row of ``perms`` (k, steps*batch); returns the (k, steps)
        per-step losses, the block's one fetch to the host."""
        self.load(params, opt_state, bits, y)
        perms_dev = torch.from_numpy(np.ascontiguousarray(perms)).to(
            self.device)
        out = []
        for perm in perms_dev:
            self.begin_epoch(perm)
            for _ in range(self.steps):
                self.step()
            out.append(self.losses.clone())
        self.store(params, opt_state)
        if not out:
            return np.zeros((0, self.steps), np.float32)
        return torch.stack(out).cpu().numpy()


_PROGRAMS: dict = {}


def step_program(cfg: DWNConfig, n: int, num_bits: int, batch: int,
                 lr: float, sched: str, device) -> StepProgram:
    """The process-wide :class:`StepProgram` of one shape (its CUDA graph
    captured once)."""
    key = (cfg, n, num_bits, batch, lr, sched, str(torch.device(device)))
    if key not in _PROGRAMS:
        _PROGRAMS[key] = StepProgram(cfg, n, num_bits, batch, lr, sched,
                                     device)
    return _PROGRAMS[key]


def owned(t, device) -> torch.Tensor:
    """A float32 copy of ``t`` on ``device`` that no caller holds."""
    return torch.as_tensor(t).detach().to(device=device,
                                          dtype=torch.float32, copy=True)


class ScanTrainer:
    """Resumable DWN trainer on one device.

    Args:
      cfg: model config.
      data: a split with ``x_train`` / ``y_train`` / ``x_test`` /
        ``y_test``; thresholds are fit on ``x_train`` when initializing.
      batch / lr / sched: paper-protocol knobs (``sched`` "steplr" or
        "constant").
      seed: the init generator's seed *and* the permutation stream's.
      params / buffers: a warm start (tensors, or anything
        ``torch.as_tensor`` takes), copied: the caller's are never
        written.
      input_frac_bits: PEN (1, n) feature quantization, folded into the
        one-time encode of the split.
      device: where to train (default ``cuda``; raises without a card).

    ``run_epochs`` advances any number of epochs with one fetch of the
    losses; ``train`` runs the paper protocol and returns a
    ``TrainResult``.
    """

    def __init__(self, cfg: DWNConfig, data, *, batch: int = 128,
                 lr: float = 1e-3, sched: str = "steplr", seed: int = 0,
                 params=None, buffers=None,
                 input_frac_bits: int | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg, self.data = cfg, data
        self.batch, self.lr, self.sched, self.seed = batch, lr, sched, seed
        self.input_frac_bits = input_frac_bits
        if params is None:
            params, buffers = init_dwn(torch.Generator().manual_seed(seed),
                                       cfg, data.x_train)
        self.params = map_tree(lambda t: owned(t, self.device), params)
        self.buffers = map_tree(lambda t: owned(t, self.device), buffers)
        self.bits_train = encode_dataset(data.x_train,
                                         self.buffers["thresholds"],
                                         input_frac_bits=input_frac_bits)
        self.y_train = torch.from_numpy(
            np.asarray(data.y_train, np.int64)).to(self.device)
        n = data.x_train.shape[0]
        self.program = step_program(cfg, n, self.bits_train.shape[1],
                                    batch, lr, sched, self.device)
        self.opt, self.steps_per_epoch = self.program.opt, \
            self.program.steps
        self.opt_state = self.opt.init(self.params)
        self.epoch = 0

    def run_epochs(self, k: int = 1) -> np.ndarray:
        """Advance ``k`` epochs; returns the (k, steps) per-step losses
        (the block's one fetch to the host)."""
        n = self.data.x_train.shape[0]
        perms = np.stack([
            epoch_permutation(n, self.steps_per_epoch, self.batch,
                              seed=self.seed, epoch=self.epoch + i)
            for i in range(k)]).astype(np.int64)
        losses = self.program.run(self.params, self.opt_state,
                                  self.bits_train, self.y_train, perms)
        self.epoch += k
        return losses

    def evaluate(self) -> float:
        """Soft test accuracy (``core.training.eval_soft``)."""
        from ..core.training import eval_soft
        return eval_soft(self.params, self.buffers, self.cfg,
                         self.data.x_test, self.data.y_test,
                         self.input_frac_bits)

    def train(self, epochs: int, *, eval_every: int = 1,
              verbose: bool = False):
        """Run the paper protocol: per-epoch history with periodic eval.

        ``eval_every=0`` evaluates only after the last epoch and runs all
        epochs as one block.  A history row's ``sec`` is the block's wall
        time per epoch, its eval included, as the reference counts it.
        """
        from ..core.training import TrainResult
        history = []
        block = epochs if eval_every <= 0 else eval_every
        done = 0
        while done < epochs:
            k = min(block, epochs - done)
            t0 = time.time()
            losses = self.run_epochs(k)
            acc = self.evaluate()
            sec = (time.time() - t0) / k
            for i in range(k):
                evaluated = i == k - 1
                history.append({"epoch": done + i,
                                "loss": float(np.mean(losses[i])),
                                "test_acc": acc if evaluated else None,
                                "sec": sec})
                if verbose:
                    acc_s = f"test_acc={acc:.4f} " if evaluated else ""
                    print(f"  epoch {done + i:3d} "
                          f"loss={history[-1]['loss']:.4f} "
                          f"{acc_s}({sec:.1f}s)", flush=True)
            done += k
        final = history[-1]["test_acc"] if history else float("nan")
        return TrainResult(self.params, self.buffers, self.cfg, history,
                           final)


def train_dwn_scan(cfg: DWNConfig, data, *, epochs: int = 30,
                   batch: int = 128, lr: float = 1e-3, seed: int = 0,
                   params=None, buffers=None,
                   input_frac_bits: int | None = None,
                   sched: str = "steplr", eval_every: int = 1,
                   verbose: bool = True, device=None):
    """:class:`ScanTrainer` run through the paper protocol."""
    trainer = ScanTrainer(cfg, data, batch=batch, lr=lr, sched=sched,
                          seed=seed, params=params, buffers=buffers,
                          input_frac_bits=input_frac_bits, device=device)
    return trainer.train(epochs, eval_every=eval_every, verbose=verbose)


__all__ = ["ScanTrainer", "StepProgram", "encode_dataset",
           "epoch_permutation", "full_float32", "make_optimizer",
           "step_program", "train_dwn_scan"]
