"""Vectorized event timeline of the packet dataplane.

The packet-level counterpart of the analytic M/G/1 model in
``switch/queueing.py``: every packet gets a sampled arrival time (Poisson
per client), a sampled loss/retransmission history, and a departure time
from an explicit FIFO service recursion — fixed-shape tensor ops (one sort
and one cumulative max), never a per-packet Python loop.

The FIFO recursion ``D_k = max(A_k, D_{k-1}) + S_k`` is computed in closed
form:  with ``P = cumsum(S)``,

    D_k = P_k + max_{j<=k} (A_j - P_{j-1})

*Absent* packets (lost, past-deadline, or belonging to a masked-out client
row) are ``+inf`` arrivals: they sort to the tail, never perturb a finite
prefix of the max-plus recursion, and are excluded from the
completion/wait statistics.

Every float prefix sum is :func:`repro_torch.core.xla_math.cumsum` and
every ``log`` XLA's (:mod:`repro_torch.core.xla_math`), so arrival times,
the vote deadline mask and the departures equal the reference's bit for
bit.  The statistics reached through a float reduction may differ from it
in the last bits: the mean wait, and the mean client rate beyond 32
clients.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import prng, xla_math
from repro_torch.switch.queueing import UNALIGNED_FACTOR, SwitchProfile

from .policies import BackoffPolicy

__all__ = ["poisson_arrivals", "lose_packets", "retransmit_delays",
           "deadline_mask", "mg1_departures", "drain_fifo", "windowed_drain",
           "simulate_round_time", "DrainStats", "service_time",
           "download_time"]

_INF = float("inf")


def _f32(x, device=None) -> torch.Tensor:
    """``x`` (a number, array or tensor) as float32, on ``device`` if given
    (else on its own device, the host for numbers and arrays)."""
    if isinstance(x, torch.Tensor) and device is None:
        device = x.device
    return torch.as_tensor(np.asarray(x) if isinstance(x, (list, tuple))
                           else x, dtype=torch.float32, device=device)


def poisson_arrivals(key: torch.Tensor, rates, n_packets: int,
                     start) -> torch.Tensor:
    """[N, P] arrival times: client i emits packet j as a Poisson process of
    rate ``rates[i]`` pkt/s starting at ``start[i]`` (its local-train end;
    a scalar ``start`` broadcasts).  On ``key``'s device."""
    rates = _f32(rates, key.device)
    n = rates.shape[0]
    gaps = prng.exponential(key, (n, int(n_packets))) / rates[:, None]
    start = _f32(start, key.device).expand(n).reshape(n, 1)
    return start + xla_math.cumsum(gaps, 1)


def lose_packets(key: torch.Tensor, shape, loss) -> torch.Tensor:
    """bool mask of *delivered* packets under i.i.d. loss (single attempt —
    the phase-1 vote path: no retransmission, quorum absorbs the gap).
    ``loss == 0`` delivers everything (uniforms live in [0, 1))."""
    return prng.uniform(key, tuple(shape)) >= _f32(loss, key.device)


def retransmit_delays(key: torch.Tensor, shape, loss, rto_s,
                      max_retries: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Persistent ARQ (the phase-2 value path): every packet is eventually
    delivered; attempt counts are geometric(1-loss) truncated at
    ``max_retries + 1``.  Returns (added delay per packet, retransmission
    count per packet — each retransmission re-emits the packet's bytes).

    The geometric draw is inverted from one uniform per packet
    (``floor(log U / log loss) + 1``), which at loss == 0 collapses to a
    single attempt for every packet.  The retry clock is
    :class:`~repro_torch.netsim.policies.BackoffPolicy` at factor 1, whose
    ``total_delay`` is ``retx * float32(rto_s)``.
    """
    loss = _f32(loss, key.device)
    u = torch.clamp_min(prng.uniform(key, tuple(shape)), 1e-38)
    log_loss = xla_math.log(torch.clamp_min(loss, 1e-38))
    attempts = torch.floor(xla_math.log(u) / log_loss).to(torch.int32) + 1
    attempts = torch.clamp(attempts, 1, int(max_retries) + 1)
    retx = torch.where(loss > 0.0, attempts - 1, 0).to(torch.int32)
    arq = BackoffPolicy(base_s=float(rto_s), factor=1.0,
                        max_retries=int(max_retries))
    return arq.total_delay(retx), retx


def deadline_mask(arrivals: torch.Tensor, deadline) -> torch.Tensor:
    """bool mask of packets that make a quorum deadline.  The boundary is
    *inclusive*: a packet arriving exactly at ``vote_deadline_s`` counts."""
    arrivals = _f32(arrivals)
    return arrivals <= _f32(deadline, arrivals.device)


@dataclass
class DrainStats:
    """Statistics of one FIFO drain: 0-d tensors (plain numbers for an
    empty drain)."""

    completion_s: object     # last departure from the switch
    mean_wait_s: object      # mean FIFO queueing delay (excl. service)
    n_packets: object        # finite (present) packets drained


def mg1_departures(arrivals, service_s, *,
                   assume_sorted: bool = False) -> torch.Tensor:
    """FIFO departure times for a flat arrival array.

    ``service_s`` is a scalar or per-packet array (matched to the sorted
    arrival order).  Returned in sorted-arrival order.  Pass
    ``assume_sorted=True`` when the caller already sorted.  ``+inf``
    arrivals (masked-out packets) yield ``+inf`` departures and never
    disturb the finite prefix.
    """
    a = _f32(arrivals).reshape(-1)
    if not assume_sorted:
        a = torch.sort(a).values
    s = _f32(service_s, a.device).expand(a.shape)
    p = xla_math.cumsum(s, 0)
    # D_k = P_k + running_max(A_j - P_{j-1})
    return p + torch.cummax(a - (p - s), 0).values


def _masked_drain(arrivals: torch.Tensor, service_s) -> DrainStats:
    """Drain over a (possibly +inf-masked) arrival array.

    ``completion_s`` is ``-inf`` when every packet is masked — callers
    ``where`` it against their fallback."""
    a = torch.sort(_f32(arrivals).reshape(-1)).values
    d = mg1_departures(a, service_s, assume_sorted=True)
    live = torch.isfinite(a)
    n = live.sum(dtype=torch.int32)
    s = _f32(service_s, a.device).expand(a.shape)
    waits = torch.where(live, d - a - s, 0.0)
    completion = torch.where(live, d, -_INF).max()
    return DrainStats(completion, waits.sum() / torch.clamp_min(n, 1), n)


def drain_fifo(arrivals, service_s) -> DrainStats:
    """Eager-friendly drain: empty/all-masked input degenerates to zeros."""
    a = _f32(arrivals)
    if a.numel() == 0:
        return DrainStats(0.0, 0.0, 0)
    st = _masked_drain(a, service_s)
    empty = st.n_packets == 0
    return DrainStats(torch.where(empty, 0.0, st.completion_s),
                      st.mean_wait_s, st.n_packets)


def _columns(x: torch.Tensor, cols: np.ndarray) -> torch.Tensor:
    """``x[:, cols]``: a slice when ``cols`` is a contiguous run."""
    lo, hi = int(cols[0]), int(cols[-1]) + 1
    if hi - lo == cols.size:
        return x[:, lo:hi]
    return x[:, torch.as_tensor(cols, device=x.device)]


def windowed_drain(arrivals: torch.Tensor, packet_window: np.ndarray,
                   n_windows: int, service_s,
                   not_before=0.0) -> tuple[torch.Tensor, DrainStats]:
    """Drain arrivals through a register-window schedule.

    ``packet_window[j]`` maps packet column j to its memory window; window
    ``w + 1`` only opens once window ``w`` has fully drained (the switch's
    registers are flushed between passes).  Clients hold/retransmit packets
    for a closed window, so an early arrival is clamped to its window-open
    time.  Loops over windows only (a handful), never packets.

    ``packet_window`` is a host array (the window -> packet-column
    partition is static structure); ``arrivals`` may hold ``+inf`` rows.
    Returns (per-window completion times, merged stats).
    """
    packet_window = np.asarray(packet_window)
    dev = arrivals.device
    t_free = _f32(not_before, dev)
    completions = []
    wait_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_tot = torch.zeros((), dtype=torch.int32, device=dev)
    for w in range(int(n_windows)):
        cols = np.flatnonzero(packet_window == w)
        if cols.size == 0:
            completions.append(t_free)
            continue
        st = _masked_drain(torch.maximum(_columns(arrivals, cols), t_free),
                           service_s)
        t_free = torch.where(st.n_packets > 0, st.completion_s, t_free)
        completions.append(t_free)
        wait_sum = wait_sum + st.mean_wait_s * st.n_packets
        n_tot = n_tot + st.n_packets
    return (torch.stack(completions),
            DrainStats(t_free, wait_sum / torch.clamp_min(n_tot, 1), n_tot))


def service_time(profile: SwitchProfile, aligned: bool = True) -> float:
    """Per-packet switch service time; unaligned sparse streams pay the
    index-alignment penalty exactly as the analytic model does."""
    return profile.rho * (1.0 if aligned else UNALIGNED_FACTOR)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of a short vector (one value per client) from +0.0 in
    index order.  XLA's CPU reduce adds in order up to 32 elements, so
    this is ``jnp.sum``'s value bit for bit there; past that its order
    differs (by float32 rounding)."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for v in x:
        acc = acc + v
    return acc


def _mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean of a short vector as ``jnp.mean`` takes it: the
    in-order sum times the float32 reciprocal of the length."""
    return _sum_in_order(x) * torch.tensor(1.0 / x.shape[0],
                                           dtype=torch.float32,
                                           device=x.device)


def download_time(download_packets, rates) -> torch.Tensor:
    """Broadcast at 5x the mean client upload rate (paper Sec. V-A2)."""
    rates = _f32(rates)
    return (_f32(download_packets, rates.device)
            / (5.0 * _mean(rates)))


def simulate_round_time(*, packets_per_client: int, download_packets: int,
                        rates, profile: SwitchProfile, local_train_s,
                        key: torch.Tensor, aligned: bool = True,
                        loss: float = 0.0, rto_s: float = 0.05,
                        max_retries: int = 16) -> float:
    """Packet-level counterpart of ``queueing.round_wall_clock``: one
    sampled upload phase + broadcast, single switch, reliable delivery,
    on ``key``'s device."""
    k_arr, k_retx = prng.split(key)
    arr = poisson_arrivals(k_arr, rates, packets_per_client, local_train_s)
    delay, _ = retransmit_delays(k_retx, arr.shape, loss, rto_s, max_retries)
    st = drain_fifo(arr + delay, service_time(profile, aligned))
    return float(st.completion_s
                 + download_time(download_packets, _f32(rates, key.device)))
