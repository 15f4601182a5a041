"""Synthetic datasets (the box is offline; see DESIGN.md §6).

* ``lm_batches``  — token streams for the transformer substrate.
* ``classification`` — a learnable non-IID-partitionable classification
  task standing in for CIFAR/FEMNIST in the paper-reproduction benchmarks:
  class-conditional Gaussians around random prototypes, noisy enough that
  accuracy climbs over rounds rather than saturating instantly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ClassificationData:
    x: np.ndarray        # (n, dim) float32
    y: np.ndarray        # (n,) int64
    n_classes: int

    def test_split(self, frac: float = 0.2):
        n_test = int(len(self.y) * frac)
        return (ClassificationData(self.x[n_test:], self.y[n_test:], self.n_classes),
                ClassificationData(self.x[:n_test], self.y[:n_test], self.n_classes))


def classification(n: int = 12_000, dim: int = 64, n_classes: int = 10,
                   noise: float = 1.6, seed: int = 0) -> ClassificationData:
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, dim)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n)
    x = protos[y] + noise * rng.normal(size=(n, dim)).astype(np.float32)
    # a nonlinear twist so a linear model doesn't solve it instantly
    x = np.concatenate([x, np.tanh(x[:, : dim // 2]) * x[:, dim // 2:]], axis=1)
    return ClassificationData(x.astype(np.float32), y.astype(np.int64), n_classes)


def lm_batches(rng: np.random.Generator, vocab: int, batch: int, seq: int,
               n_batches: int):
    """Markov-chain token streams: learnable bigram structure."""
    trans = rng.dirichlet(np.ones(min(vocab, 64)) * 0.3, size=min(vocab, 64))
    for _ in range(n_batches):
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, min(vocab, 64), size=batch)
        for t in range(seq):
            p = trans[toks[:, t] % 64]
            c = (p.cumsum(-1) > rng.random((batch, 1))).argmax(-1)
            toks[:, t + 1] = c % vocab
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "targets": toks[:, 1:].astype(np.int32)}
