"""The aggregator interface the FL simulator calls, with FediAC bound in.

    delta, residuals, state, TrafficStats, SwitchLoad = agg(u_stack, state, key)

Every algorithm is a numeric **core** ``core(u_stack, state, key, dyn)``
returning ``(delta, residuals, state, aux)`` and a host-side wire
**account** ``account(n, d, aux)`` pricing the round.  Only FediAC is
ported; the reference's other five baselines (fedavg, switchml, topk,
omnireduce, libra) and the packet transport are queued in ROADMAP.
"""

from __future__ import annotations

from dataclasses import dataclass

from .fediac import FediACConfig, aggregate_round, round_traffic

__all__ = ["SwitchLoad", "fediac_round", "make_aggregator", "make_transport"]


@dataclass(frozen=True)
class SwitchLoad:
    """What the PS has to do for one round (drives the queuing model)."""

    slot_adds: int          # integer additions across all clients' uploads
    packets_per_client: int  # upload packets per client (1500 B MTU)
    aligned: bool           # True if the PS can add streams blindly in-order


def _packets(bytes_per_client: int, mtu: int = 1500) -> int:
    return max(1, -(-bytes_per_client // mtu))


def _fediac_core(u_stack, state, key, dyn, *, cfg: FediACConfig = FediACConfig()):
    delta, residuals, counts, _ = aggregate_round(u_stack, cfg, key,
                                                  a=dyn.get("a"))
    return delta, residuals, state, {}


def _fediac_account(n: int, d: int, aux, *, cfg: FediACConfig = FediACConfig()):
    traffic = round_traffic(cfg, d)
    load = SwitchLoad(
        slot_adds=n * (d // cfg.vote_chunk) // 8 + n * traffic.selected,
        packets_per_client=_packets(traffic.total_bytes), aligned=True)
    return traffic, load


_CORES = {"fediac": (_fediac_core, _fediac_account)}
_NOT_PORTED = ("fedavg", "switchml", "topk", "omnireduce", "libra")


def _run_eager(name, u_stack, state, key, **kwargs):
    """The eager interface: core, then account on the aux ints."""
    core, account = _CORES[name]
    delta, residuals, state, aux = core(u_stack, state, key, {}, **kwargs)
    aux = {k: int(v) for k, v in aux.items()}
    n, d = u_stack.shape
    traffic, load = account(n, d, aux, **kwargs)
    return delta, residuals, state, traffic, load


def fediac_round(u_stack, state, key, *, cfg: FediACConfig = FediACConfig(),
                 **_):
    """FediAC wrapped in the common interface."""
    return _run_eager("fediac", u_stack, state, key, cfg=cfg)


_REGISTRY = {"fediac": fediac_round}


def make_aggregator(name: str, **kwargs):
    """Bind kwargs onto a registered aggregator."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"aggregator {name!r} is not ported yet "
                                  "(ROADMAP A6: the other five baselines)")
    fn = _REGISTRY[name]

    def agg(u_stack, state, key):
        return fn(u_stack, state, key, **kwargs)

    agg.__name__ = name
    return agg


def make_transport(name: str, *, transport: str = "memory", **kwargs):
    """Bind an aggregator into a round transport.  Only the in-memory
    transport (aggregator call, analytic wall-clock) is ported."""
    if transport == "memory":
        from repro_torch.netsim.transport import InMemoryTransport
        return InMemoryTransport(make_aggregator(name, **kwargs))
    if transport == "packet":
        raise NotImplementedError("the packet transport is not ported yet "
                                  "(ROADMAP A9: packet dataplane)")
    raise ValueError(f"unknown transport {transport!r} "
                     "(expected 'memory' or 'packet')")
