"""Deterministic synthetic data (no datasets, no download).

Port of ``repro.data.pipeline``. ``SyntheticLM`` is a Markov-chain token
stream with enough structure that a small LM's loss falls well below the
uniform entropy: the training runs and the convergence tests use it. It is
the reference's numpy code, so its tokens equal the reference's bit for
bit; batches are int32 tensors on the host (the train loop moves them to
the device). It is deterministic per (seed, step), sharded per host by
taking every ``num_hosts``-th batch, and resumable from any step offset
(the fault-tolerance contract). Its dense ``(vocab, vocab)`` float32
transition matrix and cumsum take ``8 * vocab**2`` bytes of host memory:
185 GB at qwen1.5-0.5b's 151,936 tokens, so a full-vocabulary model trains
on a smaller data vocabulary.

``TeacherDataset``: inputs labelled by a frozen random teacher MLP, drawn
from the port's ``core.rng.Key`` (the reference draws from ``jax.random``;
the values differ).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.rng import Key


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    order: int = 1          # Markov order
    concentration: float = 0.3  # lower -> more predictable

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse-ish row-stochastic transition matrix
        self._trans = rng.dirichlet(
            np.full(v, self.concentration), size=v).astype(np.float32)
        self._cum = np.cumsum(self._trans, axis=1)

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S, v = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, v, B)
        u = rng.random((B, S))
        for t in range(1, S):
            rows = self._cum[toks[:, t - 1]]
            toks[:, t] = (u[:, t:t + 1] < rows).argmax(axis=1)
        return {"inputs": torch.from_numpy(toks),
                "labels": torch.from_numpy(toks.copy())}

    def iterator(self, start_step: int = 0, *, host: int = 0,
                 num_hosts: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step * num_hosts + host)
            step += 1

    def entropy_floor(self) -> float:
        """Mean conditional entropy of the chain (nats) — the loss floor."""
        p = self._trans
        h = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=1)
        return float(h.mean())


@dataclasses.dataclass
class TeacherDataset:
    """Classification set labelled by a frozen random teacher network, on
    ``device`` (the card unless it names another)."""
    d_in: int
    n_classes: int
    seed: int = 0
    hidden: int = 64
    device: str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        k1, k2, _ = Key(self.seed).split(3)
        self.w1 = k1.normal((self.d_in, self.hidden),
                            self.device) * self.d_in ** -0.5
        self.w2 = k2.normal((self.hidden, self.n_classes),
                            self.device) * self.hidden ** -0.5

    def batch(self, step: int, batch_size: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        x = Key(self.seed + 1).fold_in(step).normal((batch_size, self.d_in),
                                                    self.device)
        logits = torch.relu(x @ self.w1) @ self.w2
        return x, torch.argmax(logits, dim=-1)


def batch_iterator(source: SyntheticLM, start_step: int = 0
                   ) -> Iterator[dict]:
    return source.iterator(start_step)
