"""M/G/1 queuing wall-clock model of the in-network FL round (paper Sec. V-A2).

Clients upload packets as Poisson processes with per-client rates drawn from
the paper's NYC-cellular-trace range (200-2,800 packets/s).  The PS is an
M/G/1 server: packet arrivals at rate lambda_s = sum_i lambda_i, service
time with mean ``rho`` and variance ``var`` (Gaussian in the paper;
high-perf PS: rho = 3.03e-7 s, low-perf: 3.03e-6 s, var = 2.15e-8).
Expected waiting time is Pollaczek-Khinchine:

    W = lambda_s * E[S^2] / (2 * (1 - lambda_s * E[S]))

Unstable queues (utilization >= 1) degrade to service-bound throughput.
Downloads run at 5x the mean client upload rate (paper).  Unaligned sparse
streams (plain Top-k) cost the PS an index-alignment factor per packet —
the paper's motivation-example penalty, configurable below.

The model is analytic (expected values), so benchmark results are exactly
reproducible; randomness enters only through the per-client rates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HIGH_PERF_RHO = 3.03e-7
LOW_PERF_RHO = 3.03e-6
SERVICE_VAR = 2.15e-8
UNALIGNED_FACTOR = 4.0   # per-packet index-alignment penalty for the PS


@dataclass(frozen=True)
class SwitchProfile:
    rho: float                 # mean service time per packet (s)
    var: float = SERVICE_VAR   # service-time variance
    name: str = "high"

    @staticmethod
    def high():
        return SwitchProfile(HIGH_PERF_RHO, SERVICE_VAR, "high")

    @staticmethod
    def low():
        return SwitchProfile(LOW_PERF_RHO, SERVICE_VAR, "low")


def client_rates(n_clients: int, seed: int = 0) -> np.ndarray:
    """Per-client packet upload rates from the trace range (packets/s)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(200.0, 2800.0, size=n_clients)


def round_wall_clock(*, packets_per_client: int, download_packets: int,
                     rates: np.ndarray, profile: SwitchProfile,
                     local_train_s: float, aligned: bool = True) -> float:
    """Expected wall-clock seconds for one global iteration."""
    n = len(rates)
    lam_s = float(rates.sum())
    rho = profile.rho * (1.0 if aligned else UNALIGNED_FACTOR)
    es2 = profile.var + rho * rho            # E[S^2]
    util = lam_s * rho
    if util < 1.0:
        wait = lam_s * es2 / (2.0 * (1.0 - util))
    else:
        wait = 0.0  # fully service-bound; cost lands in the service term below
    total_packets = packets_per_client * n
    # upload finishes when the slowest client drains its packets
    upload = packets_per_client / rates.min()
    # PS must service every packet; overlaps with uploads when stable
    service = total_packets * rho
    ps_time = max(0.0, service - upload) + wait if util < 1.0 else service + wait
    # download at 5x mean client rate (paper)
    download = download_packets / (5.0 * rates.mean())
    return local_train_s + upload + ps_time + download
