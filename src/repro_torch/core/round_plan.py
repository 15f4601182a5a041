"""The per-round consensus plan: FediAC's GIA as a first-class object.

Phase-2 selection is a deterministic function of the summed vote counts,
identical on every client (paper Sec. III-B).  :func:`build_round_plan`
runs that selection exactly once per round, and every client's compress
step takes the resulting :class:`RoundPlan`.

One plan object serves both compact modes: the top-k plan (``idx``/``keep``
plus the dense ``sel`` mask of the fused kernel) and the block plan
(``keep_dense``/``pos``).  The streaming slot map is queued in ROADMAP.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import compaction

__all__ = ["RoundPlan", "build_round_plan", "consensus_floor_threshold"]


def consensus_floor_threshold(counts: torch.Tensor, a, floor: int) -> torch.Tensor:
    """Dense-mask fallback: when fewer than ``floor`` coordinates reach the
    vote threshold the round degrades to ``a = 1`` (every voted coordinate
    is kept) instead of aggregating a near-empty selection.  Stays on the
    device: the result only enters ``counts >= a`` comparisons."""
    a = torch.as_tensor(a, dtype=torch.int32, device=counts.device)
    live = (counts >= a).sum(dtype=torch.int32)
    return torch.where(live < floor, torch.ones_like(a), a)


class RoundPlan(NamedTuple):
    """Consensus selection for one round, shared by all N clients.

    topk mode: ``idx`` int32[C] consensus coordinate order (count-desc,
    index-asc — the stable top_k permutation), ``keep`` float32[C] in
    {0,1} flagging entries whose count reached the vote threshold.

    block mode: ``keep_dense`` bool[d] selected coordinates, ``pos``
    int32[d] slot-in-block for the cumsum compaction.

    ``sel`` uint8[d] is the dense 0/1 selection mask, built on demand (for
    the fused gather-quant kernel in topk mode; it is ``keep_dense`` in
    block mode).
    """

    idx: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None
    keep_dense: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    sel: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1] if self.idx is not None else 0


def build_round_plan(counts: torch.Tensor, cfg, n_clients: int, *, a=None,
                     with_dense_mask: bool = False) -> RoundPlan:
    """Run the once-per-round consensus selection from the vote counts.

    ``counts`` int32[d//g] summed votes; ``cfg`` a FediACConfig; ``a``
    optionally overrides ``cfg.threshold(n_clients)``.
    """
    if a is None:
        a = cfg.threshold(n_clients)
    if getattr(cfg, "consensus_floor", 0) > 0:
        a = consensus_floor_threshold(counts, a, cfg.consensus_floor)
    if cfg.compact_mode == "block":
        keep_dense, pos = compaction.block_select(counts, a, cfg.block_size,
                                                  cfg.capacity_frac)
        sel = keep_dense.to(torch.uint8) if with_dense_mask else None
        return RoundPlan(keep_dense=keep_dense, pos=pos, sel=sel)
    n_chunks = counts.shape[-1]
    idx, keep = compaction.consensus_indices(counts, a, cfg.capacity(n_chunks))
    sel = None
    if with_dense_mask:
        sel = torch.zeros((n_chunks,), dtype=torch.uint8, device=counts.device)
        sel[idx.long()] = keep.to(torch.uint8)
    return RoundPlan(idx=idx, keep=keep, sel=sel)
