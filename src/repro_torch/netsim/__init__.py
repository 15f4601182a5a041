"""Executable packet-level switch dataplane.

Runs FediAC rounds as packet streams through memory-limited programmable
switches: Poisson packet timelines, loss + retransmission, stragglers and
partial participation, a vote-quorum deadline, finite int32 register
windows, and a leaf -> root multi-switch hierarchy.  The FediAC round is
a fixed-shape core of tensors (``netsim.batched``) run on the device of
the update stack, and the lossless full-participation configuration is
bit-identical to the in-memory ``core.fediac.aggregate_stack`` engine.
A :class:`FaultConfig` runs the round through the chaos core
(``netsim.faults``: bursty loss, crashes, duplicates, reordering, register
faults, quorum retry) and an ``AdversaryConfig`` through the
Byzantine-robust core of :mod:`repro_torch.robust`; both are bitwise the
plain core with their knobs at zero.  The asynchronous core is not ported
yet.
"""

from .batched import (make_fediac_packet_core, packet_dyn, reliable_upload,
                      scale_num_table, threshold_table)
from .dataplane import DataplaneStats, SwitchDataplane, n_windows, slot_window
from .faults import (FaultConfig, chaos_packet_dyn, gilbert_elliott_stationary,
                     make_chaos_packet_core)
from .hierarchy import aggregate_hierarchy, drain_hierarchy, leaf_assignment
from .policies import (NetConfig, REGISTER_POLICIES, net_round_key,
                       register_accumulate, sample_participants,
                       sample_stragglers)
from .timeline import (DrainStats, deadline_mask, download_time, drain_fifo,
                       lose_packets, mg1_departures, poisson_arrivals,
                       retransmit_delays, simulate_round_time, windowed_drain)
from .transport import InMemoryTransport, PacketTransport, RoundResult, Transport

__all__ = ["DataplaneStats", "SwitchDataplane", "n_windows", "slot_window",
           "aggregate_hierarchy",
           "drain_hierarchy", "leaf_assignment", "NetConfig", "net_round_key",
           "sample_participants", "sample_stragglers", "DrainStats",
           "deadline_mask", "download_time", "drain_fifo", "lose_packets",
           "mg1_departures",
           "poisson_arrivals", "retransmit_delays", "simulate_round_time",
           "windowed_drain", "InMemoryTransport", "PacketTransport",
           "RoundResult", "Transport", "make_fediac_packet_core",
           "packet_dyn", "reliable_upload", "scale_num_table",
           "threshold_table", "FaultConfig", "chaos_packet_dyn",
           "gilbert_elliott_stationary", "make_chaos_packet_core",
           "REGISTER_POLICIES", "register_accumulate"]
