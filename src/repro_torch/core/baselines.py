"""The in-network aggregation algorithms the paper compares (Sec. V-A3),
behind the one interface the FL simulator calls:

    delta, residuals, state, TrafficStats, SwitchLoad = agg(u_stack, state, key)

``u_stack`` float32[N, d] holds the client updates with their carried
residuals; ``delta`` float32[d] is the mean update the global model takes.
Every algorithm is a numeric **core** ``core(u_stack, state, key, dyn)``
returning ``(delta, residuals, state, aux)``, on the stack's device, and a
host-side wire **account** ``account(n, d, aux)`` pricing the round from
the static config and the ``aux`` integers:

* ``fedavg``: the uncompressed float mean;
* ``switchml``: dense b-bit stochastic quantization, aligned integer sums;
* ``topk``: per-client top-k, unaligned (every pair costs a slot);
* ``omnireduce``: per-client top-k, uploaded as the non-zero blocks;
* ``libra``: a hot set from an EMA of |u| aggregated in-network, each
  client's cold top-k sent to a server;
* ``fediac``: FediAC (:mod:`.fediac`).

Each is bitwise equal to the reference's eager call on the same inputs
and key.  Three habits get there:

* top-k sets are a stable descending sort, lower index first among equal
  magnitudes, as ``lax.top_k`` orders them (updates hold exact zeros);
* a mean over clients adds them in client order and multiplies by the
  float32 reciprocal of N, which is how ``jnp.mean`` evaluates;
* a division by ``f`` or by N is tensor / device tensor: torch turns
  ``float / tensor`` into a reciprocal multiply, and on the card does the
  same to ``tensor / host scalar``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import prng
from .fediac import FediACConfig, TrafficStats, aggregate_round, round_traffic
from .quantize import dequantize, quantize, scale_factor

__all__ = ["SwitchLoad", "fedavg", "switchml", "topk_server", "omnireduce",
           "libra", "fediac_round", "make_aggregator", "make_aggregator_core",
           "make_transport"]


@dataclass(frozen=True)
class SwitchLoad:
    """What the PS has to do for one round (drives the queuing model)."""

    slot_adds: int          # integer additions across all clients' uploads
    packets_per_client: int  # upload packets per client (1500 B MTU)
    aligned: bool           # True if the PS can add streams blindly in-order


def _packets(bytes_per_client: int, mtu: int = 1500) -> int:
    return max(1, -(-bytes_per_client // mtu))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _client_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=0)`` of a float32 ``[N, ...]`` stack: the rows
    added in client order onto a zero (so that a column of -0.0 sums to
    +0.0, as XLA's reduction from its init value does), times the float32
    reciprocal of N."""
    total = torch.zeros_like(x[0])
    for row in x:
        total += row
    return total * _f32(np.float32(1) / np.float32(x.shape[0]), x)


def _topk_mask(u: torch.Tensor, k: int) -> torch.Tensor:
    """float32 0/1 masks of the k largest |u| of each row (``lax.top_k``'s
    order: lower index first among ties)."""
    _, idx = torch.sort(u.abs(), dim=-1, descending=True, stable=True)
    mask = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    return mask.scatter_(-1, idx[..., :k], 1.0)


# ---------------------------------------------------------------------------
# cores: the round math on the stack's device; aux = data-dependent wire ints
# ---------------------------------------------------------------------------

def _fedavg_core(u_stack, state, key, dyn):
    return _client_mean(u_stack), torch.zeros_like(u_stack), state, {}


def _fedavg_account(n: int, d: int, aux):
    traffic = TrafficStats(phase1_bytes=0, phase2_bytes=4 * d, dense_bytes=4 * d,
                           selected=d)
    load = SwitchLoad(slot_adds=n * d, packets_per_client=_packets(4 * d),
                      aligned=True)
    return traffic, load


def _switchml_core(u_stack, state, key, dyn, *, bits: int = 12):
    n, _ = u_stack.shape
    m = torch.clamp_min(u_stack.abs().max(), 1e-12)
    f = _f32(scale_factor(bits, n, 1.0), u_stack) / m
    uni = prng.uniform(key, u_stack.shape)
    q = quantize(u_stack, f, uni)
    delta = dequantize(q.sum(dim=0, dtype=torch.int32), f) / _f32(n, u_stack)
    # SwitchML streams b-bit slots; no error feedback (the quantizer is
    # unbiased)
    return delta, torch.zeros_like(u_stack), state, {}


def _switchml_account(n: int, d: int, aux, *, bits: int = 12):
    bytes_pc = d * bits // 8
    traffic = TrafficStats(phase1_bytes=0, phase2_bytes=bytes_pc,
                           dense_bytes=4 * d, selected=d)
    load = SwitchLoad(slot_adds=n * d, packets_per_client=_packets(bytes_pc),
                      aligned=True)
    return traffic, load


def _topk_core(u_stack, state, key, dyn, *, k_frac: float = 0.01):
    _, d = u_stack.shape
    k = max(1, int(k_frac * d))
    sparse = u_stack * _topk_mask(u_stack, k)
    return _client_mean(sparse), u_stack - sparse, state, {}


def _topk_account(n: int, d: int, aux, *, k_frac: float = 0.01):
    k = max(1, int(k_frac * d))
    bytes_pc = k * 8  # (int32 index, fp32 value) pairs
    traffic = TrafficStats(phase1_bytes=0, phase2_bytes=bytes_pc,
                           dense_bytes=4 * d, selected=k)
    load = SwitchLoad(slot_adds=n * k, packets_per_client=_packets(bytes_pc),
                      aligned=False)
    return traffic, load


def _omnireduce_core(u_stack, state, key, dyn, *, k_frac: float = 0.05,
                     block: int = 256):
    n, d = u_stack.shape
    k = max(1, int(k_frac * d))
    pad = (-d) % block
    masks = _topk_mask(u_stack, k)
    sparse = u_stack * masks
    mp = torch.nn.functional.pad(masks, (0, pad))
    blocks_nz = mp.reshape(n, -1, block).amax(dim=-1) > 0
    blocks_per_client = blocks_nz.sum(dim=-1, dtype=torch.int32)
    avg_blocks = torch.ceil(_client_mean(blocks_per_client.to(torch.float32))
                            ).to(torch.int32)
    aux = {"avg_blocks": avg_blocks,
           "nz_blocks": blocks_nz.sum(dtype=torch.int32)}
    return _client_mean(sparse), u_stack - sparse, state, aux


def _omnireduce_account(n: int, d: int, aux, *, k_frac: float = 0.05,
                        block: int = 256):
    avg_blocks = int(aux["avg_blocks"])
    bytes_pc = avg_blocks * (block * 4 + 4)  # block payload + block id
    traffic = TrafficStats(phase1_bytes=0, phase2_bytes=bytes_pc,
                           dense_bytes=4 * d, selected=avg_blocks * block)
    load = SwitchLoad(slot_adds=int(aux["nz_blocks"]) * block,
                      packets_per_client=_packets(bytes_pc), aligned=True)
    return traffic, load


def _libra_core(u_stack, state, key, dyn, *, k_frac: float = 0.01,
                hot_frac: float = 0.01):
    _, d = u_stack.shape
    k = max(1, int(k_frac * d))
    h = max(1, int(hot_frac * d))
    heat_now = _client_mean(u_stack.abs())
    heat = heat_now if state is None else state
    # the hot set: aggregated at the PS for every client (aligned)
    hot_mask = _topk_mask(heat, h)
    hot_part = u_stack * hot_mask
    # cold: per-client top-k of the remainder, server-aggregated
    cold = u_stack * (1.0 - hot_mask)
    cold_part = cold * _topk_mask(cold, k)
    uploaded = hot_part + cold_part
    new_state = 0.9 * heat + 0.1 * heat_now
    return _client_mean(uploaded), u_stack - uploaded, new_state, {}


def _libra_account(n: int, d: int, aux, *, k_frac: float = 0.01,
                   hot_frac: float = 0.01):
    k = max(1, int(k_frac * d))
    h = max(1, int(hot_frac * d))
    bytes_pc = h * 4 + k * 8
    traffic = TrafficStats(phase1_bytes=0, phase2_bytes=bytes_pc,
                           dense_bytes=4 * d, selected=h + k)
    load = SwitchLoad(slot_adds=n * h, packets_per_client=_packets(bytes_pc),
                      aligned=True)
    return traffic, load


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


_CORES = {
    "fedavg": (_fedavg_core, _fedavg_account),
    "switchml": (_switchml_core, _switchml_account),
    "topk": (_topk_core, _topk_account),
    "omnireduce": (_omnireduce_core, _omnireduce_account),
    "libra": (_libra_core, _libra_account),
    "fediac": (_fediac_core, _fediac_account),
}


def _run_eager(name, u_stack, state, key, **kwargs):
    """The eager interface: core, then account on the aux ints."""
    core, account = _CORES[name]
    delta, residuals, state, aux = core(u_stack, state, key, {}, **kwargs)
    aux = {k: int(v) for k, v in aux.items()}
    n, d = u_stack.shape
    traffic, load = account(n, d, aux, **kwargs)
    return delta, residuals, state, traffic, load


def fedavg(u_stack, state, key, **_):
    return _run_eager("fedavg", u_stack, state, key)


def switchml(u_stack, state, key, *, bits: int = 12, **_):
    """Dense unbiased integer quantization, aligned pipelined aggregation."""
    return _run_eager("switchml", u_stack, state, key, bits=bits)


def topk_server(u_stack, state, key, *, k_frac: float = 0.01, **_):
    """Per-client Top-k; indices differ per client, so the PS cannot align."""
    return _run_eager("topk", u_stack, state, key, k_frac=k_frac)


def omnireduce(u_stack, state, key, *, k_frac: float = 0.05, block: int = 256,
               **_):
    """Top-k sparsify, then upload every block that holds a non-zero."""
    return _run_eager("omnireduce", u_stack, state, key, k_frac=k_frac,
                      block=block)


def libra(u_stack, state, key, *, k_frac: float = 0.01, hot_frac: float = 0.01,
          **_):
    """Hot/cold split: a slowly updated global hot set is aggregated
    in-network; each client's cold top-k goes to a server.  ``state`` is
    the EMA of coordinate heat |u| that predicts the hot set."""
    return _run_eager("libra", u_stack, state, key, k_frac=k_frac,
                      hot_frac=hot_frac)


def fediac_round(u_stack, state, key, *, cfg: FediACConfig = FediACConfig(),
                 **_):
    """FediAC wrapped in the common interface."""
    return _run_eager("fediac", u_stack, state, key, cfg=cfg)


_REGISTRY = {
    "fedavg": fedavg,
    "switchml": switchml,
    "topk": topk_server,
    "omnireduce": omnireduce,
    "libra": libra,
    "fediac": fediac_round,
}


def make_aggregator(name: str, **kwargs):
    """Bind kwargs onto a registered aggregator."""
    fn = _REGISTRY[name]

    def agg(u_stack, state, key):
        return fn(u_stack, state, key, **kwargs)

    agg.__name__ = name
    return agg


def make_aggregator_core(name: str, **kwargs):
    """Bind kwargs onto the ``(core, account)`` pair of a registered
    algorithm: ``core(u_stack, state, key, dyn)`` is the round math
    (``dyn`` carries FediAC's vote threshold ``{"a": ...}``) and
    ``account(n, d, aux)`` prices the round from the ints ``core``
    returned."""
    core, account = _CORES[name]

    def bound_core(u_stack, state, key, dyn):
        return core(u_stack, state, key, dyn, **kwargs)

    def bound_account(n, d, aux):
        return account(n, d, aux, **kwargs)

    bound_core.__name__ = f"{name}_core"
    bound_account.__name__ = f"{name}_account"
    return bound_core, bound_account


def make_transport(name: str, *, transport: str = "memory", net=None,
                   profile=None, rates=None, local_train_s: float = 0.1,
                   **kwargs):
    """Bind an aggregator into a round transport.

    ``transport="memory"`` wraps the plain aggregator call (analytic
    wall-clock); ``transport="packet"`` runs the round through the
    executable packet dataplane (:mod:`repro_torch.netsim`) with the
    loss/straggler/participation/hierarchy policies of ``net`` (a
    ``netsim.NetConfig``), the switch ``profile``, the per-client ``rates``
    and ``local_train_s``.  ``kwargs`` are the aggregator kwargs, exactly
    as for :func:`make_aggregator`.  The imports are lazy so importing
    ``repro_torch.core`` never pulls the simulator package in.
    """
    if transport == "memory":
        from repro_torch.netsim.transport import InMemoryTransport
        return InMemoryTransport(make_aggregator(name, **kwargs))
    if transport == "packet":
        from repro_torch.netsim.transport import PacketTransport
        return PacketTransport(name, kwargs, net=net, profile=profile,
                               rates=rates, local_train_s=local_train_s)
    raise ValueError(f"unknown transport {transport!r} "
                     "(expected 'memory' or 'packet')")
