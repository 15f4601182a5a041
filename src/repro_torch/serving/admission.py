"""Admission-queue / continuous-batching primitives (DESIGN.md §7, §17).

The slot-scheduling core shared by the decode serving engine
(``serving/engine.py``) and the async FL aggregation server
(``netsim/async_engine.py``): a FIFO of pending work items feeds a fixed
pool of slots; freed slots immediately admit the next pending item
(continuous batching), and an ``on_admit`` hook resets per-slot state
(KV-cache rows for decode, register windows for aggregation) without
disturbing neighbouring slots.

Nothing here touches jax — the queue is pure host-side bookkeeping, so
both engines keep their compiled programs unchanged while sharing one
admission discipline.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """FIFO admission into a fixed pool of reusable slots.

    ``admit()`` scans slots in index order and fills every free one from
    the head of the queue — the exact continuous-batching discipline the
    serving engine has always used, so extracting it changes no
    scheduling decision.  ``on_admit(slot, item)`` fires once per
    admission, before the item is considered active.
    """

    def __init__(self, n_slots: int,
                 on_admit: Callable[[int, object], None] | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.slots: list = [None] * self.n_slots
        self.pending: deque = deque()
        self.on_admit = on_admit

    # -- queue side ---------------------------------------------------
    def submit(self, item) -> None:
        """Append ``item`` to the pending FIFO."""
        self.pending.append(item)

    def admit(self) -> list[tuple[int, object]]:
        """Fill free slots (index order) from the queue head.

        Returns the ``(slot, item)`` pairs admitted this call.
        """
        admitted: list[tuple[int, object]] = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.pending:
                item = self.pending.popleft()
                self.slots[i] = item
                if self.on_admit is not None:
                    self.on_admit(i, item)
                admitted.append((i, item))
        return admitted

    # -- slot side ----------------------------------------------------
    def release(self, slot: int):
        """Free ``slot`` for recycling; returns the evicted item."""
        item = self.slots[slot]
        self.slots[slot] = None
        return item

    def active(self) -> Iterator[tuple[int, object]]:
        """Yield ``(slot, item)`` for every occupied slot, index order."""
        for i, item in enumerate(self.slots):
            if item is not None:
                yield i, item

    # -- introspection ------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    def idle(self) -> bool:
        """True when no slot is occupied and nothing is queued."""
        return self.n_active == 0 and not self.pending
