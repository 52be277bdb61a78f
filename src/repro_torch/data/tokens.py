"""Deterministic synthetic LM token pipeline (shardable, resumable).

The port's own copy of the reference's ``repro.data.tokens`` (numpy
only): the same (seed, step, host) gives the same batch in both packages.

No datasets ship in this container, so the LM examples/tests train on a
synthetic integer-sequence language with learnable structure (a mixture
of n-gram-ish Markov chains + copy motifs), generated deterministically
from (seed, step, host) — which makes the iterator:

* **shardable**: each data-parallel host draws its own disjoint batch
  slice by construction (no coordination, no file system),
* **resumable**: state is just the step counter (rides in the checkpoint
  manifest), skip-ahead is O(1),
* **order-robust**: batch content depends only on (seed, step), not on
  worker scheduling.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    step: int = 0                      # iterator state (checkpointable)

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        master = np.random.default_rng(self.seed ^ 0x5EED)
        # fixed Markov backbone: per-state preferred successors
        self._trans = master.integers(
            0, self.vocab_size, (min(self.vocab_size, 4096), 4))

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def next_batch(self) -> dict:
        """Returns {tokens, labels} of shape (host_batch, seq_len)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step, self.host_id]))
        B, S, V = self.host_batch, self.seq_len, self.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        follow = rng.random((B, S)) < 0.85          # Markov vs random
        rand = rng.integers(0, V, (B, S))
        choice = rng.integers(0, 4, (B, S))
        for t in range(1, S):
            prev = toks[:, t - 1] % self._trans.shape[0]
            nxt = self._trans[prev, choice[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, rand[:, t])
        self.step += 1
        return {"tokens": toks, "labels": toks.copy()}


__all__ = ["TokenStream"]
