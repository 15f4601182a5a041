"""The Transport abstraction: how a round's bytes reach the aggregate.

Only :class:`InMemoryTransport` is ported: it calls the aggregator
directly and reports no simulated time, so the FL loop prices the round
with the analytic ``round_wall_clock`` model.  The packet dataplane is
queued in ROADMAP.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.baselines import SwitchLoad
from repro_torch.core.fediac import TrafficStats

__all__ = ["RoundResult", "InMemoryTransport"]


@dataclass
class RoundResult:
    """Everything one aggregation round hands back to the FL loop."""

    delta: torch.Tensor        # mean update to apply to the global model
    residuals: torch.Tensor    # [N, d] error-feedback state (full stack)
    state: Any                 # aggregator state
    traffic: TrafficStats
    load: SwitchLoad
    n_active: int              # clients that uploaded phase-2 values


class InMemoryTransport:
    """Aggregator call, analytic time."""

    def __init__(self, agg):
        self.agg = agg

    def round(self, u_stack, state, key, round_idx: int = 0) -> RoundResult:
        delta, residuals, state, traffic, load = self.agg(u_stack, state, key)
        return RoundResult(delta, residuals, state, traffic, load,
                           n_active=u_stack.shape[0])
