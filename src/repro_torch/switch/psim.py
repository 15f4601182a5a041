"""Programmable-switch semantics simulator.

Models the two constraints the paper designs around (Sec. I / III-B):
  1. integer-only arithmetic — ``aggregate_stream`` only accepts ints;
  2. scarce memory — the PS owns ``memory_slots`` int32 registers; a round
     that needs more *live* aligned slots than that must run in multiple
     sequential passes ("aggregations" in the paper's counting).

``aligned`` streams (identical index order on every client — FediAC's GIA,
SwitchML's dense slots, OmniReduce's block ids) are added blindly slot by
slot.  Unaligned streams (per-client Top-k indices) must keep an
(index -> slot) map: every miss evicts to the server, which is the paper's
motivation example — we count those as extra aggregation ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PSStats:
    aggregation_ops: int      # slot additions executed on the PS
    passes: int               # sequential memory-limited passes
    server_redirects: int     # values the PS could not align (sent upstream)


class ProgrammableSwitch:
    def __init__(self, memory_slots: int = 262_144):
        # 1 MB of int32 registers by default (paper Sec. I example)
        self.memory_slots = int(memory_slots)

    def aggregate_aligned(self, streams: np.ndarray) -> tuple[np.ndarray, PSStats]:
        """streams: int array (N, d) in identical coordinate order."""
        if not np.issubdtype(streams.dtype, np.integer):
            raise TypeError("PS only performs integer arithmetic")
        n, d = streams.shape
        passes = -(-d // self.memory_slots)
        out = streams.sum(axis=0, dtype=np.int64)
        # paper's counting (Sec. III-B): aggregating N aligned streams of d
        # values takes (N-1)*d additions.
        return out, PSStats(aggregation_ops=(n - 1) * d, passes=passes,
                            server_redirects=0)

    def aggregate_sparse(self, indices: list[np.ndarray],
                         values: list[np.ndarray], d: int) -> tuple[np.ndarray, PSStats]:
        """Per-client (index, value) streams with arbitrary alignment.

        Slot accounting is fully vectorized: in stream order, the first
        ``memory_slots`` *distinct* indices claim registers (every touch of
        a slotted index is one aggregation op); any value whose index never
        got a slot redirects to the server.  Ranking distinct indices by
        first appearance (``np.unique`` + a stable argsort) reproduces the
        sequential slot-map semantics exactly, orders faster at d ~ 1e6.
        """
        for val in values:
            if not np.issubdtype(np.asarray(val).dtype, np.integer):
                raise TypeError("PS only performs integer arithmetic")
        if not indices or sum(len(np.atleast_1d(i)) for i in indices) == 0:
            return np.zeros(d, np.int64), PSStats(0, 1, 0)
        idx_all = np.concatenate([np.atleast_1d(np.asarray(i, np.int64))
                                  for i in indices])
        val_all = np.concatenate([np.atleast_1d(np.asarray(v, np.int64))
                                  for v in values])
        out = np.zeros(d, np.int64)
        np.add.at(out, idx_all, val_all)
        uniq, first_pos = np.unique(idx_all, return_index=True)
        arrival_rank = np.empty(uniq.size, np.int64)
        arrival_rank[np.argsort(first_pos, kind="stable")] = np.arange(uniq.size)
        in_slot = arrival_rank[np.searchsorted(uniq, idx_all)] < self.memory_slots
        ops = int(in_slot.sum())
        return out, PSStats(aggregation_ops=ops, passes=1,
                            server_redirects=int(idx_all.size - ops))
