"""Consensus compaction: the payoff of FediAC's consensus property.

Because the GIA is identical on every client (a deterministic function of
the summed vote counts), every client gathers its selected values into a
fixed-capacity buffer in the same order, so phase 2 sums ``C << d``
integers with no index metadata.  Selection depends only on the vote
counts: the top-C coordinates in stable top-k order, with entries whose
count is below the threshold ``a`` zeroed.  Surplus coordinates stay in
the error-feedback residual.

The sort-free block compaction (``compact_mode="block"``) keeps, in each
fixed block of coordinates, the first ``c_b = capacity_frac * block_size``
selected ones, located with a cumsum: O(d), no sort, and still a function
of the shared vote counts only.
"""

from __future__ import annotations

import torch

from . import selection

__all__ = ["consensus_indices", "compact", "scatter_compact", "block_plan",
           "block_select", "block_compact", "block_scatter"]


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


# ---------------------------------------------------------------------------
# Sort-free block compaction
# ---------------------------------------------------------------------------

def block_plan(d: int, block_size: int, capacity_frac: float):
    """``(blocks nb, per-block capacity cb, padding)`` of a d-vector."""
    nb = -(-d // block_size)
    cb = max(1, int(round(capacity_frac * block_size)))
    return nb, cb, nb * block_size - d


def block_select(counts: torch.Tensor, a, block_size: int,
                 capacity_frac: float):
    """counts ``[d]`` -> ``(keep bool[d], pos int32[d])``: whether each
    coordinate is kept, and its slot within its block (the number of
    selected coordinates before it in the block)."""
    d = counts.shape[-1]
    nb, cb, _ = block_plan(d, block_size, capacity_frac)
    sel = torch.zeros(nb * block_size, dtype=torch.bool, device=counts.device)
    sel[:d] = counts >= a
    sel = sel.reshape(nb, block_size)
    s32 = sel.to(torch.int32)
    pos = torch.cumsum(s32, dim=1, dtype=torch.int32) - s32
    keep = sel & (pos < cb)
    return keep.reshape(-1)[:d], pos.reshape(-1)[:d]


def _block_slots(keep: torch.Tensor, pos: torch.Tensor, block_size: int,
                 cb: int) -> torch.Tensor:
    """Each coordinate's flat buffer slot ``block * cb + pos``."""
    block = torch.arange(keep.shape[-1], device=keep.device) // block_size
    return block * cb + pos


def block_compact(values: torch.Tensor, keep: torch.Tensor, pos: torch.Tensor,
                  block_size: int, capacity_frac: float) -> torch.Tensor:
    """Gather the kept values of ``[..., d]`` into the ``[..., nb*cb]``
    consensus buffer (row by row for a client stack).

    Kept coordinates own distinct slots, so the reference's scatter-add
    into a zero buffer is one add per slot; every other coordinate adds 0
    into one spare slot past the end, which is cut off.
    """
    d = values.shape[-1]
    nb, cb, _ = block_plan(d, block_size, capacity_frac)
    slots = torch.where(keep, _block_slots(keep, pos, block_size, cb), nb * cb)
    buf = torch.zeros((*values.shape[:-1], nb * cb + 1), dtype=values.dtype,
                      device=values.device)
    buf.index_add_(-1, slots, torch.where(keep, values, 0))
    return buf[..., :-1]


def block_scatter(buf: torch.Tensor, keep: torch.Tensor, pos: torch.Tensor,
                  d: int, block_size: int, capacity_frac: float) -> torch.Tensor:
    """Inverse of :func:`block_compact`: ``[nb*cb]`` buffer -> ``[d]``
    vector, a gather (zeros where not kept)."""
    _, cb, _ = block_plan(d, block_size, capacity_frac)
    vals = buf[_block_slots(keep, pos.clamp(0, cb - 1), block_size, cb)]
    return torch.where(keep, vals, torch.zeros((), dtype=buf.dtype,
                                               device=buf.device))
