"""The executable switch dataplane: a finite int32 register bank
(DESIGN.md §9).

Where ``switch/psim.py`` *counts* what a memory-limited PS would do, this
module *does* it: a ``SwitchDataplane`` owns ``memory_slots`` int32
registers, aggregates one memory window of the consensus buffer at a time,
and flushes between windows — a round whose live compact buffer exceeds
the bank runs in ``ceil(C / memory_slots)`` sequential passes, matching
``ProgrammableSwitch.aggregate_aligned``'s pass count.

Values are applied per *window* rather than per packet: phase-2 delivery
is reliable (persistent ARQ, ``policies.NetConfig``), so the integer sums
are order-independent and the per-packet granularity only matters for the
*timeline* (``timeline.windowed_drain`` prices it).  Arithmetic is int32
with wraparound — exactly what ``aggregate_stack``'s ``q_bufs.sum(0)``
computes — so the packet path is bit-identical to the in-memory engine,
not merely close.

That same associativity is what lets the jittable round core
(DESIGN.md §13) replace the explicit register-bank walk with one masked
int32 ``sum(axis=0)``: this module is now the *value-plane reference
oracle* — ``tests/test_netsim.py`` pins the masked sum against
``aggregate_windowed``/``aggregate_hierarchy`` — while the window/pass
accounting it defines (``n_windows``) still shapes the traced timeline.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

__all__ = ["DataplaneStats", "SwitchDataplane", "n_windows", "slot_window"]


def n_windows(n_slots: int, memory_slots: int) -> int:
    """Sequential register windows needed for ``n_slots`` live slots."""
    return max(1, -(-int(n_slots) // int(memory_slots)))


def slot_window(n_slots: int, memory_slots: int) -> np.ndarray:
    """int32[n_slots] — which register window each buffer slot lands in."""
    return (np.arange(int(n_slots)) // int(memory_slots)).astype(np.int32)


@dataclass
class DataplaneStats:
    """What one round did to one switch."""

    votes_lost: int = 0          # vote chunk-coords dropped (not retried)
    passes: int = 1              # sequential register windows (psim semantics)
    peak_live_slots: int = 0     # widest window actually resident
    aggregation_ops: int = 0     # integer slot-additions executed
    overflow_slots: int = 0      # registers whose true sum left int32 range
                                 # (the value wrapped silently — DESIGN.md §14)
    late_folds: int = 0          # updates past the async close carried into
                                 # the next round, staleness-weighted (§17)
    late_bounces: int = 0        # updates past the close returned whole to
                                 # the client's residual (§17)
    stuffed_votes: int = 0       # ballots injected beyond honest top-k (§18)
    budget_rejected: int = 0     # ballots the per-client vote budget refused
    clipped_values: int = 0      # slot values clamped by the tick clip (§18)
    trimmed_values: int = 0      # slot values excluded by the order-statistic
                                 # close (2 * t per live slot — §18)

    # fields that combine by max across switches (levels run concurrently,
    # so the hierarchy's pass count / residency is the widest switch's, not
    # the sum); every other field is an additive event count.  Listing the
    # *exceptions* keeps ``merge`` field-complete by construction: a field
    # added to this dataclass is summed unless deliberately put here.
    _MAX_FIELDS = frozenset({"passes", "peak_live_slots"})

    def merge(self, other: "DataplaneStats") -> "DataplaneStats":
        vals = {}
        for f in fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            vals[f.name] = max(a, b) if f.name in self._MAX_FIELDS else a + b
        return DataplaneStats(**vals)

    def to_metrics(self) -> dict:
        """The unified metric emission path (DESIGN.md §15): every field,
        as {name: float} — same contract as ``RoundResult.to_metrics``."""
        return {f.name: float(getattr(self, f.name)) for f in fields(self)}


class SwitchDataplane:
    """A single programmable switch with a finite int32 register bank."""

    def __init__(self, memory_slots: int = 262_144):
        self.memory_slots = int(memory_slots)
        self.registers = np.zeros(self.memory_slots, np.int32)
        self.stats = DataplaneStats(passes=0)

    # -- phase 1: vote counting ------------------------------------------
    def count_votes(self, votes: np.ndarray, delivered: np.ndarray) -> np.ndarray:
        """Sum delivered 0/1 vote arrays into int32 counts.

        ``votes`` uint8[N, d/g]; ``delivered`` bool[N, d/g] marks the
        coordinates whose carrying packet survived loss + quorum deadline.
        Vote counters are ceil(log2 N)-bit — the paper treats the vote pass
        as memory-cheap, so it is not windowed here.  Only delivered
        chunk-coordinates count as executed slot-additions (and the
        complement as ``votes_lost``, in the same chunk-coordinate units).
        """
        v = votes.astype(np.int32) * delivered.astype(np.int32)
        counts = v.sum(axis=0, dtype=np.int32)
        self.stats.votes_lost += int((~delivered).sum())
        self.stats.aggregation_ops += int(delivered.sum())
        return counts

    # -- phase 2: windowed integer aggregation ---------------------------
    def n_windows(self, n_slots: int) -> int:
        return n_windows(n_slots, self.memory_slots)

    def aggregate_windowed(self, bufs: np.ndarray) -> np.ndarray:
        """Aggregate int32[N, C] client buffers through the register bank.

        Runs ``ceil(C / memory_slots)`` passes; each pass zeroes the bank,
        adds every client's slice of the window slot-by-slot (int32, wrap
        semantics identical to ``jnp.sum(axis=0)``), then flushes to the
        output.  Returns the int32[C] aggregate.

        Each window is audited against an exact int64 sum: registers whose
        true sum left the int32 range wrapped silently in the bank (the
        hardware behavior) and are counted in ``stats.overflow_slots`` —
        the flag the §14 degradation policies (saturate/rescale, see
        ``policies.register_accumulate``) key off instead of shipping the
        corrupted value.
        """
        if not np.issubdtype(bufs.dtype, np.integer):
            raise TypeError("the dataplane only performs integer arithmetic")
        n, c = bufs.shape
        bufs = bufs.astype(np.int32, copy=False)
        out = np.empty(c, np.int32)
        wins = self.n_windows(c)
        for w in range(wins):
            lo = w * self.memory_slots
            hi = min(lo + self.memory_slots, c)
            self.registers[:] = 0
            np.add(self.registers[:hi - lo],
                   bufs[:, lo:hi].sum(axis=0, dtype=np.int32),
                   out=self.registers[:hi - lo], casting="unsafe")
            exact = bufs[:, lo:hi].sum(axis=0, dtype=np.int64)
            self.stats.overflow_slots += int(
                (exact != self.registers[:hi - lo]).sum())
            out[lo:hi] = self.registers[:hi - lo]      # flush
            self.stats.peak_live_slots = max(self.stats.peak_live_slots, hi - lo)
            self.stats.aggregation_ops += max(n - 1, 0) * (hi - lo)
        self.stats.passes = max(self.stats.passes, wins)
        return out
