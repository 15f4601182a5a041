"""Packetization and traffic accounting (paper Sec. V-A2: 1500 B MTU)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MTU = 1500


def n_packets(n_bytes: int, mtu: int = MTU) -> int:
    return max(1, -(-int(n_bytes) // mtu))


def packet_sizes(n_bytes: int, mtu: int = MTU) -> np.ndarray:
    """int64[n_packets] per-packet wire bytes: MTU-sized except the final
    partial packet (at least 1 byte — a zero-byte payload still rides one
    packet).  The single packet-sizing rule shared by the analytic switch
    model and the netsim dataplane's retransmission byte accounting."""
    p = n_packets(n_bytes, mtu)
    sizes = np.full(p, mtu, np.int64)
    sizes[-1] = max(1, int(n_bytes) - (p - 1) * mtu)
    return sizes


@dataclass
class RoundTraffic:
    """Per-round system-wide traffic (upload + download), bytes."""

    upload_per_client: int
    download_per_client: int
    n_clients: int

    @property
    def total(self) -> int:
        return (self.upload_per_client + self.download_per_client) * self.n_clients
