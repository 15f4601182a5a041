"""Consensus compaction: the payoff of FediAC's consensus property.

Because the GIA is identical on every client (a deterministic function of
the summed vote counts), every client gathers its selected values into a
fixed-capacity buffer in the same order, so phase 2 sums ``C << d``
integers with no index metadata.  Selection depends only on the vote
counts: the top-C coordinates in stable top-k order, with entries whose
count is below the threshold ``a`` zeroed.  Surplus coordinates stay in
the error-feedback residual.

Only the top-k compaction is ported; the sort-free block compaction
(``compact_mode="block"``) is queued in ROADMAP.
"""

from __future__ import annotations

import torch

from . import selection

__all__ = ["consensus_indices", "compact", "scatter_compact"]


def consensus_indices(counts: torch.Tensor, a, capacity: int):
    """Deterministic consensus selection from vote counts.

    Returns ``(idx, keep)``: ``idx`` int32[capacity] coordinate indices in
    stable top-k order and ``keep`` float32[capacity] in {0,1} marking
    entries with count >= a (``a`` an int or an int32 scalar tensor).
    """
    top, idx = selection.consensus_topk(counts, capacity)
    keep = (top >= a).to(torch.float32)
    return idx, keep


def compact(values: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Gather values at consensus indices into the C-sized buffer (along the
    last axis, so a client stack compacts row by row)."""
    out = values.index_select(-1, idx)
    return (out.to(torch.float32) * keep).to(values.dtype)


def scatter_compact(buf: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                    d: int) -> torch.Tensor:
    """Scatter the C-sized buffer back into a d-vector (zeros elsewhere)."""
    flat = torch.zeros((d,), dtype=buf.dtype, device=buf.device)
    flat[idx.long()] = (buf.to(torch.float32) * keep).to(buf.dtype)
    return flat
