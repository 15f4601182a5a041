"""Client-axis aggregation of the quantized contributions.

Only the paper's plain integer addition (``robust_agg="sum"``) is ported;
the trimmed-mean and median closes are queued in ROADMAP.  The sum stays
int32 (torch would promote it to int64), as the switch's registers are.
"""

from __future__ import annotations

import torch

__all__ = ["ROBUST_AGG_MODES", "client_sum", "kept_count"]

#: registered robust aggregation modes (FediACConfig.robust_agg)
ROBUST_AGG_MODES = ("sum", "trim", "median")


def _require_sum(cfg) -> None:
    if cfg.robust_agg != "sum":
        raise NotImplementedError(
            f"robust_agg={cfg.robust_agg!r} is not ported yet "
            "(ROADMAP: robust_agg trim/median)")


def client_sum(q: torch.Tensor, cfg):
    """Sum the client axis of ``[N, chunk]`` int32 contributions.  Returns
    ``(aggregated int32 [chunk], kept)`` with ``kept`` the Python int N."""
    _require_sum(cfg)
    return q.sum(dim=0, dtype=torch.int32), q.shape[0]


def kept_count(cfg, n: int) -> int:
    """The aggregation denominator of an all-live ``n``-client round."""
    _require_sum(cfg)
    return n
