"""Exact top-k selections of the round: the per-client vote and the
once-per-round consensus.

Both are the reference's ``lax.top_k`` semantics: the k largest values,
and among equal values the lower index first.  ``torch.topk`` promises no
order among ties, so both selections are a stable descending sort
(``torch.sort(..., stable=True)``), whose tie order is exactly that.

The reference reaches the same sets faster at large d: a sample-certified
threshold for the votes (``selection._certificate``) and a count
bisection for the consensus.  Those are speed devices with the same
outputs; they are queued for a later performance change (ROADMAP).
"""

from __future__ import annotations

import torch

__all__ = ["topk_indices", "topk_mask", "topk_mask_stack", "topk_counts_stack",
           "consensus_topk"]


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, value-descending and
    index-ascending among ties (``lax.top_k``'s order)."""
    _, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return idx[..., :k]


def topk_mask_stack(scores: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 ``[N, d]`` 0/1 masks of the k largest scores of each row.

    scores: float32[N, d] (no NaN).  Row sums are k.
    """
    n, d = scores.shape
    k = min(int(k), d)
    mask = torch.zeros((n, d), dtype=torch.uint8, device=scores.device)
    return mask.scatter_(1, topk_indices(scores, k), 1)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Single-vector form of :func:`topk_mask_stack`: uint8 ``[d]``."""
    return topk_mask_stack(scores[None, :], k)[0]


def topk_counts_stack(scores: torch.Tensor, k: int) -> torch.Tensor:
    """int32[d] per-coordinate membership counts of the per-row top-k sets
    (FediAC phase 1: the PS summing the clients' 0/1 vote arrays).

    scores: float32[N, d] (no NaN).
    """
    n, d = scores.shape
    k = min(int(k), d)
    if k == d:
        return torch.full((d,), n, dtype=torch.int32, device=scores.device)
    votes = torch.zeros((n, d), dtype=torch.bool, device=scores.device)
    votes.scatter_(1, topk_indices(scores, k), True)
    return votes.sum(dim=0, dtype=torch.int32)


def consensus_topk(counts: torch.Tensor, capacity: int):
    """(values, indices) of the C largest vote counts, count-descending and
    index-ascending within ties — the stable ``lax.top_k(counts, C)``."""
    capacity = min(int(capacity), counts.shape[-1])
    vals, idx = torch.sort(counts.to(torch.int32), descending=True, stable=True)
    return vals[:capacity], idx[:capacity].to(torch.int32)
