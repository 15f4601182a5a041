"""Two-level leaf -> root PS topology (paper Sec. III-B "multiple
collaborative PSes").

Clients are assigned round-robin to ``n_leaves`` leaf switches.  Each leaf
aggregates its clients' packets through its own register bank and window
schedule; when a leaf finishes a window it forwards the window's partial
sum upstream as MTU-sized packets, and the root switch aggregates the leaf
partials.  Because int32 addition is associative and commutative (mod
2^32), ``root(sum_leaf(clients))`` is bit-identical to the flat
single-switch sum — the hierarchy changes *time*, never *values* — which
is exactly the property the paper's multi-PS sketch relies on.  The
round core therefore only simulates the hierarchy's *time plane*
(:func:`drain_hierarchy`, on the device); the NumPy register-bank walk
(:func:`aggregate_hierarchy`) survives as the value-plane oracle the
equivalence tests pin against.

With ``n_leaves == 1`` the topology degenerates to the single switch and
the root hop disappears (no forwarding latency), so the flat configuration
stays comparable to the analytic ``round_wall_clock`` model.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dataplane import DataplaneStats, SwitchDataplane
from .timeline import DrainStats, mg1_departures, windowed_drain

__all__ = ["leaf_assignment", "aggregate_hierarchy", "drain_hierarchy"]

_INF = float("inf")


@functools.lru_cache(maxsize=64)
def _leaf_assignment_cached(n_clients: int, n_leaves: int) -> np.ndarray:
    out = (np.arange(n_clients) % max(1, n_leaves)).astype(np.int32)
    out.setflags(write=False)   # cached across rounds — never mutate
    return out


def leaf_assignment(n_clients: int, n_leaves: int) -> np.ndarray:
    """int32[n_clients] — round-robin client -> leaf-switch map.  Cached:
    the map is recomputed-free on the per-round hot path (the transport
    resolves it once per (N, n_leaves) instead of once per round)."""
    return _leaf_assignment_cached(int(n_clients), int(n_leaves))


def aggregate_hierarchy(bufs: np.ndarray, leaf_of: np.ndarray,
                        n_leaves: int, memory_slots: int
                        ) -> tuple[np.ndarray, DataplaneStats]:
    """Value plane: leaf partial sums, then the root adds leaf partials.

    ``bufs`` int32[N, C].  Returns (int32[C] total, merged stats).  This is
    the explicit register-bank walk — the round core computes the same
    value as one masked int32 ``sum(axis=0)`` (associativity), and the
    netsim tests pin the two against each other.
    """
    if n_leaves <= 1:
        sw = SwitchDataplane(memory_slots)
        return sw.aggregate_windowed(bufs), sw.stats
    partials = []
    stats = DataplaneStats(passes=0)
    for leaf in range(int(n_leaves)):
        rows = bufs[leaf_of == leaf]
        if rows.shape[0] == 0:
            continue
        sw = SwitchDataplane(memory_slots)
        partials.append(sw.aggregate_windowed(rows))
        stats = stats.merge(sw.stats)
    root = SwitchDataplane(memory_slots)
    total = root.aggregate_windowed(np.stack(partials))
    return total, stats.merge(root.stats)


def drain_hierarchy(arrivals, leaf_of: np.ndarray,
                    packet_window: np.ndarray, n_windows: int,
                    n_leaves: int, service_s,
                    fwd_packets_per_window: int,
                    not_before=0.0) -> DrainStats:
    """Time plane: per-leaf windowed drains, then the root services the
    forwarded partial-sum packets.

    Each leaf forwards ``fwd_packets_per_window`` packets the moment a
    window completes (back-to-back on the uplink, spaced by the service
    time); the root is one more FIFO queue over all forwarded packets.

    ``arrivals`` may carry ``+inf`` rows for masked-out clients.
    ``leaf_of`` and ``packet_window`` are host arrays (the leaf-row and
    window-column partitions are static structure).  A leaf whose rows are
    all masked forwards nothing (its forwarded packets are masked to
    ``+inf``), as the host semantics skip empty leaves.
    """
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32)
    if n_leaves <= 1:
        _, st = windowed_drain(arrivals, packet_window, n_windows, service_s,
                               not_before=not_before)
        return st
    dev = arrivals.device
    leaf_of = np.asarray(leaf_of)
    service_s = torch.as_tensor(service_s, dtype=torch.float32, device=dev)
    root_arrivals = []
    wait_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_tot = torch.zeros((), dtype=torch.int32, device=dev)
    spacing = service_s * torch.arange(1, int(fwd_packets_per_window) + 1,
                                       dtype=torch.float32, device=dev)
    for leaf in range(int(n_leaves)):
        rows = np.flatnonzero(leaf_of == leaf)
        if rows.size == 0:
            continue
        completions, st = windowed_drain(
            arrivals[torch.as_tensor(rows, device=dev)], packet_window,
            n_windows, service_s, not_before=not_before)
        wait_sum = wait_sum + st.mean_wait_s * st.n_packets
        n_tot = n_tot + st.n_packets
        fwd = (completions[:, None] + spacing[None, :]).reshape(-1)
        # an all-masked leaf forwards nothing: mask its uplink packets out
        root_arrivals.append(torch.where(st.n_packets > 0, fwd, _INF))
    flat = torch.sort(torch.cat(root_arrivals)).values
    dep = mg1_departures(flat, service_s, assume_sorted=True)
    live = torch.isfinite(flat)
    wait_sum = wait_sum + torch.where(live, dep - flat - service_s,
                                      0.0).sum()   # root queue waits too
    n_tot = n_tot + live.sum(dtype=torch.int32)
    completion = torch.where(live, dep, -_INF).max()
    return DrainStats(completion, wait_sum / torch.clamp_min(n_tot, 1), n_tot)
