"""The Transport abstraction: how a round's bytes reach the aggregate.

Two implementations share one interface:

* :class:`InMemoryTransport` calls any of the six aggregators of
  :mod:`repro_torch.core.baselines` directly and reports no simulated
  time (the FL loop falls back to the analytic ``round_wall_clock``
  model).
* :class:`PacketTransport` is the executable dataplane: the same round is
  pushed *through* switches as packet streams, with client sampling,
  stragglers, loss + ARQ, the vote-quorum deadline, the finite register
  bank (multi-pass windows) and the optional leaf -> root hierarchy.

For FediAC the packet round is the fixed-shape core of
:mod:`.batched` (or, under a ``FaultConfig``, the chaos core of
:mod:`.faults`; under an ``AdversaryConfig``, the Byzantine-robust core of
:mod:`repro_torch.robust`), run on the device of the update stack, and
:class:`PacketTransport` is the thin host-side accounting wrapper around
it.  The core re-uses the exact client-side machinery of
:mod:`repro_torch.core.fediac` and only replaces the int32 client sum with
the masked uploader sum (bit-equal to the register-bank walk by int32
associativity), so the lossless full-participation round is bitwise
``aggregate_stack`` — delta, residuals and vote counts — in every
vote/compact mode and on every engine.  For the baseline aggregators it
prices the round's packets (alignment penalty, windows, loss) around the
unchanged in-memory math, through the same timeline/hierarchy primitives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.baselines import SwitchLoad, make_aggregator
from repro_torch.core.fediac import FediACConfig, TrafficStats, round_traffic
from repro_torch.switch import SwitchProfile, client_rates, n_packets

from .batched import (make_fediac_packet_core, packet_dyn, reliable_upload,
                      retx_byte_count)
from .hierarchy import leaf_assignment
from .policies import (NetConfig, net_round_key, sample_participants,
                       sample_stragglers)
from .timeline import download_time, service_time

__all__ = ["RoundResult", "Transport", "InMemoryTransport", "PacketTransport"]


@dataclass
class RoundResult:
    """Everything one aggregation round hands back to the FL loop."""

    delta: torch.Tensor        # mean update to apply to the global model
    residuals: torch.Tensor    # [N, d] error-feedback state (full stack)
    state: Any                 # aggregator state (libra's heat EMA, the
                               # robust core's reputation / quarantine)
    traffic: TrafficStats
    load: SwitchLoad
    wall_clock_s: float | None  # simulated seconds; None = use the
                                # analytic round_wall_clock model
    n_active: int              # clients that uploaded phase-2 values
    upload_bytes: int | None = None  # total bytes actually emitted upstream
                                # this round (vote packets of *all*
                                # participants + value packets of the
                                # uploaders); None = traffic.total_bytes
                                # per active client
    stats: dict = field(default_factory=dict)

    def to_metrics(self) -> dict:
        """Every scalar stat plus derived consensus/health gauges, as
        {name: float}.  It reads the delta and residual norms back from
        the device, so only an observer that wants them calls it."""
        out = {"n_active": float(self.n_active)}
        if self.upload_bytes is not None:
            out["upload_bytes"] = float(self.upload_bytes)
        if self.wall_clock_s is not None:
            out["wall_clock_s"] = float(self.wall_clock_s)
        tr = self.traffic
        if tr is not None:
            out["phase1_bytes"] = float(tr.phase1_bytes)
            out["phase2_bytes"] = float(tr.phase2_bytes)
        part = self.stats.get("participants")
        if part is not None:
            out["n_part"] = float(np.asarray(part).sum())
        up = self.stats.get("uploaders")
        if up is not None:
            out["n_up"] = float(np.asarray(up).size)
        for k, v in self.stats.items():
            if k in out or isinstance(v, (np.ndarray, torch.Tensor,
                                          list, tuple)):
                continue
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                continue
        counts = self.stats.get("vote_counts")
        if counts is not None:
            c = np.asarray(counts, float)
            n_part = out.get("n_part", 0.0)
            if c.size and n_part > 0:
                # mean fraction of participants voting for a chunk
                out["vote_agreement_frac"] = float(c.mean() / n_part)
            a = self.stats.get("vote_threshold_a")
            if a is not None:
                # chunks whose votes met the consensus threshold
                out["consensus_k"] = float((c >= float(a)).sum())
        if self.delta is not None:
            out["delta_norm"] = float(torch.linalg.norm(self.delta))
        if self.residuals is not None:
            out["residual_norm"] = float(torch.linalg.norm(self.residuals))
        return out


class Transport(Protocol):
    def round(self, u_stack: torch.Tensor, state: Any, key: torch.Tensor,
              round_idx: int = 0) -> RoundResult: ...


class InMemoryTransport:
    """Aggregator call, analytic time."""

    def __init__(self, agg):
        self.agg = agg

    def round(self, u_stack, state, key, round_idx: int = 0) -> RoundResult:
        delta, residuals, state, traffic, load = self.agg(u_stack, state, key)
        return RoundResult(delta, residuals, state, traffic, load,
                           wall_clock_s=None, n_active=u_stack.shape[0])


class PacketTransport:
    """Run FediAC (or a baseline) rounds as packet streams through switches.

    Parameters mirror what the FL loop knows: the aggregator name + kwargs,
    a :class:`NetConfig`, the switch service profile, per-client Poisson
    rates (derived from ``client_rates`` if omitted) and the local training
    time.  Every round is deterministic given ``(net.seed, round_idx)``:
    all network draws are threefry keys derived from that pair
    (``policies.net_round_key``).  A round runs on the device of its
    update stack.
    """

    def __init__(self, aggregator: str, agg_kwargs: dict | None = None, *,
                 net: NetConfig | None = None,
                 profile: SwitchProfile | None = None,
                 rates: np.ndarray | None = None,
                 local_train_s: float = 0.1):
        self.name = aggregator
        self.agg_kwargs = dict(agg_kwargs or {})
        self.net = net or NetConfig()
        self.profile = profile or SwitchProfile.high()
        self.rates = None if rates is None else np.asarray(rates, float)
        self.local_train_s = float(local_train_s)
        if aggregator == "fediac":
            self.cfg = self.agg_kwargs.get("cfg", FediACConfig())
            self._agg = None
            self._cores = {}     # (n_clients, device) -> (core, dyn, key)
        else:
            self.cfg = None
            self._agg = make_aggregator(aggregator, **self.agg_kwargs)

    # ------------------------------------------------------------------
    def _round_rates(self, n: int) -> np.ndarray:
        rates = self.rates
        if rates is None or len(rates) != n:
            rates = client_rates(n, self.net.seed)
        return rates

    def round(self, u_stack, state, key, round_idx: int = 0) -> RoundResult:
        if self.name == "fediac":
            return self._fediac_round(u_stack, state, key, round_idx)
        return self._generic_round(u_stack, state, key, round_idx)

    # ------------------------------------------------------------------
    # FediAC: the fixed-shape round core + host accounting
    # ------------------------------------------------------------------
    def _core_for(self, n: int, device: torch.device):
        if (n, device) not in self._cores:
            from repro_torch.robust import (AdversaryConfig,
                                            adversary_packet_dyn,
                                            make_robust_packet_core)

            from .faults import (FaultConfig, chaos_packet_dyn,
                                 make_chaos_packet_core)
            svc = service_time(self.profile, aligned=True)
            if isinstance(self.net, AdversaryConfig):
                # the Byzantine-robust dataplane: attacks and switch-side
                # defenses over the chaos core, bitwise it with every knob
                # at zero (checked before FaultConfig, its superclass)
                make, make_dyn = make_robust_packet_core, adversary_packet_dyn
            elif isinstance(self.net, FaultConfig):
                # the chaos dataplane: fault-injected, bitwise the plain
                # core at zero fault rates
                make, make_dyn = make_chaos_packet_core, chaos_packet_dyn
            else:
                make, make_dyn = make_fediac_packet_core, packet_dyn
            core = make(self.cfg, self.net, n)
            dyn = make_dyn(self.cfg, self.net, n, self.local_train_s, svc,
                           device=device)
            net_key = prng.PRNGKey(self.net.seed, device=device)
            self._cores[(n, device)] = (core, dyn, net_key)
        return self._cores[(n, device)]

    def _fediac_round(self, u_stack, state, key, round_idx) -> RoundResult:
        from repro_torch.robust import (ROBUST_STAT_FIELDS, AdversaryConfig,
                                        init_reputation_state)

        from .faults import CHAOS_STAT_FIELDS
        cfg = self.cfg
        n, d = u_stack.shape
        core, dyn, net_key = self._core_for(n, u_stack.device)
        rates = torch.as_tensor(self._round_rates(n), dtype=torch.float32,
                                device=u_stack.device)
        if isinstance(self.net, AdversaryConfig):
            # the reputation / quarantine state rides the aggregator-state
            # slot, which the FL loop threads round to round and
            # checkpoints as agg_state
            if state is None:
                state = init_reputation_state(n, device=u_stack.device)
            delta, residuals, aux, state = core(u_stack, state, key, net_key,
                                                round_idx, rates, dyn)
        else:
            delta, residuals, aux = core(u_stack, key, net_key, round_idx,
                                         rates, dyn)
        n_up = int(aux["n_up"])
        n_part = int(aux["n_part"])
        tr = round_traffic(cfg, d)
        stats = {"vote_counts": aux["counts"].cpu().numpy(),
                 "participants": aux["participants"].cpu().numpy(),
                 "uploaders": np.flatnonzero(aux["uploaders"].cpu().numpy()),
                 "phase1_s": float(aux["phase1_s"]),
                 "votes_lost": int(aux["votes_lost"]),
                 "stragglers": int(aux["n_strag"]),
                 "retransmissions": int(aux["retransmissions"]),
                 "passes": int(aux["passes"]),
                 "peak_live_slots": int(aux["peak_live_slots"]),
                 "aggregation_ops": int(aux["aggregation_ops"]),
                 "phase2_s": float(aux["phase2_s"]),
                 "mean_wait_s": float(aux["mean_wait_s"]),
                 # consensus/occupancy context; the core resolves a from
                 # the uploader count (m = 0 maps to 1, as threshold_table)
                 "vote_threshold_a": float(cfg.threshold(n_up)) if n_up
                                     else 1.0,
                 "register_occupancy": (float(aux["peak_live_slots"])
                                        / float(self.net.memory_slots))}
        # the chaos and robust cores' extras
        for k in CHAOS_STAT_FIELDS + ROBUST_STAT_FIELDS:
            if k in aux:
                stats[k] = int(aux[k])
        # voters that missed the quorum still spent their phase-1 bytes,
        # and every ARQ retransmission re-emits its packet's bytes
        retx_bytes = retx_byte_count(aux["retransmissions"],
                                     aux["retx_last"], tr.phase2_bytes,
                                     self.net.mtu)
        n_up_wire = int(aux.get("n_up_wire", n_up))
        upload_bytes = (tr.phase1_bytes * n_part + tr.phase2_bytes * n_up_wire
                        + retx_bytes)
        return RoundResult(delta, residuals, state, tr,
                           self._fediac_load(cfg, n_up if n_up else n, d, tr),
                           wall_clock_s=float(aux["wall_clock_s"]),
                           n_active=n_up, upload_bytes=upload_bytes,
                           stats=stats)

    def _fediac_load(self, cfg, n, d, tr) -> SwitchLoad:
        return SwitchLoad(
            slot_adds=n * (d // cfg.vote_chunk) // 8 + n * tr.selected,
            packets_per_client=n_packets(tr.total_bytes, self.net.mtu),
            aligned=True)

    # ------------------------------------------------------------------
    # Baselines: in-memory math, packet-priced delivery (on the same keyed
    # timeline primitives as the FediAC core)
    # ------------------------------------------------------------------
    def _generic_round(self, u_stack, state, key, round_idx) -> RoundResult:
        net = self.net
        u = u_stack
        dev = u.device
        n, d = u.shape
        rates = self._round_rates(n)
        rk = net_round_key(net.seed, round_idx, device=dev)
        k_part, k_strag, _, _, k_arr2, k_retx = prng.split(rk, 6)
        part_t = sample_participants(k_part, n, net.participation)
        part = part_t.cpu().numpy()
        strag = sample_stragglers(k_strag, part_t,
                                  net.straggler_frac).cpu().numpy()
        # float64 on the host, as the reference prices the baselines
        slow = np.where(strag, net.straggler_slowdown, 1.0)
        train_s = self.local_train_s * slow
        eff_rates = rates / slow
        p_idx = np.flatnonzero(part)
        rows = torch.as_tensor(p_idx, device=dev)

        delta, res_up, state, tr, load = self._agg(u[rows], state, key)
        svc = service_time(self.profile, aligned=load.aligned)
        live = tr.selected if load.aligned else min(tr.selected,
                                                    net.memory_slots)
        leaf_of = leaf_assignment(n, net.n_leaves)[p_idx]
        st, n_retx, retx_last, n_win = reliable_upload(
            k_arr2, k_retx, eff_rates[p_idx], train_s[p_idx], live,
            tr.total_bytes, leaf_of, svc, loss=net.loss, rto_s=net.rto_s,
            max_retries=net.max_retries, memory_slots=net.memory_slots,
            n_leaves=net.n_leaves, mtu=net.mtu)
        retx_bytes = retx_byte_count(n_retx, retx_last, tr.total_bytes,
                                     net.mtu)
        wall = float(st.completion_s
                     + download_time(n_packets(tr.total_bytes, net.mtu),
                                     torch.as_tensor(rates, device=dev)))
        residuals = u.clone()
        residuals[rows] = res_up
        stats = {"participants": part, "uploaders": p_idx,
                 "retransmissions": int(n_retx), "passes": n_win,
                 "stragglers": int(strag.sum()),
                 "mean_wait_s": float(st.mean_wait_s)}
        return RoundResult(delta, residuals, state, tr, load,
                           wall_clock_s=wall, n_active=int(p_idx.size),
                           upload_bytes=(tr.total_bytes * int(p_idx.size)
                                         + int(retx_bytes)),
                           stats=stats)
