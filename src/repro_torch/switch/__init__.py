"""The switch's packet and queueing models and the programmable-switch
simulator (host-side numpy, copied from the reference)."""

from .packets import MTU, RoundTraffic, n_packets, packet_sizes
from .psim import ProgrammableSwitch, PSStats
from .queueing import SwitchProfile, client_rates, round_wall_clock

__all__ = ["MTU", "RoundTraffic", "n_packets", "packet_sizes",
           "ProgrammableSwitch", "PSStats",
           "SwitchProfile", "client_rates", "round_wall_clock"]
