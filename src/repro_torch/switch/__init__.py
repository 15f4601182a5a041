"""The switch's packet and queueing models (host-side numpy, copied from
the reference; the programmable-switch simulator is not ported yet)."""

from .packets import MTU, RoundTraffic, n_packets, packet_sizes
from .queueing import SwitchProfile, client_rates, round_wall_clock

__all__ = ["MTU", "RoundTraffic", "n_packets", "packet_sizes",
           "SwitchProfile", "client_rates", "round_wall_clock"]
