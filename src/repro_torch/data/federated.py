"""Federated data partitioning (paper Sec. V-A1).

IID: shuffle and split evenly.  Non-IID: per-client label distributions
drawn from Dirichlet(beta) — the paper's protocol with default beta=0.5.
"""

from __future__ import annotations

import numpy as np

from .synthetic import ClassificationData


def partition_iid(data: ClassificationData, n_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(data.y))
    return [ClassificationData(data.x[s], data.y[s], data.n_classes)
            for s in np.array_split(idx, n_clients)]


def partition_dirichlet(data: ClassificationData, n_clients: int,
                        beta: float = 0.5, seed: int = 0):
    """Dirichlet label-skew partition [Li et al., CVPR'21 protocol]."""
    rng = np.random.default_rng(seed)
    by_class = [np.flatnonzero(data.y == c) for c in range(data.n_classes)]
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c_idx in by_class:
        rng.shuffle(c_idx)
        props = rng.dirichlet(np.full(n_clients, beta))
        cuts = (np.cumsum(props) * len(c_idx)).astype(int)[:-1]
        for i, s in enumerate(np.split(c_idx, cuts)):
            client_idx[i].extend(s.tolist())
    out = []
    for s in client_idx:
        s = np.array(s, np.int64)
        if len(s) == 0:  # guarantee non-empty clients
            s = rng.integers(0, len(data.y), size=4)
        rng.shuffle(s)
        out.append(ClassificationData(data.x[s], data.y[s], data.n_classes))
    return out
