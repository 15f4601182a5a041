"""Chaos dataplane: deterministic fault injection for the packet round.

:class:`FaultConfig` extends :class:`~repro_torch.netsim.policies.NetConfig`
with the failure modes a real in-network aggregation point concentrates —
bursty (Gilbert–Elliott) link loss, clients crashing mid-round, ACK loss
producing duplicate retransmissions, packet reordering, and register-bank
faults (int32 overflow, window resets) — together with the degradation
policies that keep the round *correct* under them: sequence-numbered
duplicate suppression, saturate/rescale register closing, and
quorum-or-abort round retry with bounded exponential backoff on the
simulated clock.

Every fault draw derives from the per-round threefry key the benign
policies use (``net_round_key(seed, round_idx)``), folded at the
reference's constants (7001–7005, 7100 + attempt), so a faulty round
replays bit for bit and equals the reference's.  All fault models are
fixed-shape mask algebra over the ``[N, P]`` packet tensors, with the
fault rates entering as 0-d tensors through ``dyn``
(:func:`chaos_packet_dyn`), so the round runs on the device without
reading anything back.

With every fault knob at its zero default the chaos core is bitwise
:func:`repro_torch.netsim.batched.make_fediac_packet_core`:

* Gilbert–Elliott only modulates the *threshold* the plain path's loss
  uniforms are compared against (its own key drives the channel chain),
  so ``ge_p_gb == 0`` is bitwise ``lose_packets``;
* crash / duplicate / reset effects are masks that are the identity at
  rate zero, and duplicate packets are extra ``+inf``-arrival columns,
  which the drain's finite-masked statistics ignore;
* reordering jitter adds ``uniform * 0.0 == +0.0`` at rate zero;
* the register bank's wrap mode is bitwise the int32 column sum;
* quorum retry is gated in Python on its zero default.

The helpers below (phase 1 with its quorum retry, the GIA and phase-2
compress, the faulty upload, the register close, the accounting) are
shared with the Byzantine-robust core of :mod:`repro_torch.robust.core`.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engines, prng, xla_math
from repro_torch.core.fediac import (FediACConfig, client_vote_stack,
                                     round_traffic)
from repro_torch.switch import n_packets
from repro_torch.validate import (check_at_least, check_choice,
                                  check_finite_at_least, check_interval,
                                  require)

from .batched import (PACKET_DYN_FIELDS, _at, _gia_compress, _scatter_delta,
                      _value_ops, packet_dyn, scale_num_table)
from .dataplane import n_windows, slot_window
from .hierarchy import drain_hierarchy, leaf_assignment
from .policies import (BackoffPolicy, NetConfig, REGISTER_POLICIES, _f32,
                       register_accumulate, sample_participants,
                       sample_stragglers)
from .timeline import (_masked_drain, _sum_in_order, deadline_mask,
                       download_time, poisson_arrivals, retransmit_delays)

__all__ = ["FaultConfig", "FAULT_DYN_FIELDS", "CHAOS_STAT_FIELDS",
           "make_chaos_packet_core", "chaos_packet_dyn",
           "gilbert_elliott_stationary"]

#: the chaos-only aux scalars the core returns on top of the benign ones
#: (``PacketTransport`` folds exactly these into its stats dict)
CHAOS_STAT_FIELDS = ("crashed", "duplicates", "resets", "overflow_slots",
                     "aborted", "attempts")

#: the fault rates of one scenario, appended to PACKET_DYN_FIELDS
FAULT_DYN_FIELDS = PACKET_DYN_FIELDS + (
    "ge_p_gb", "ge_p_bg", "ge_loss_bad", "crash_rate", "crash_p2_frac",
    "dup_rate", "reorder_jitter_s", "reg_reset_rate", "backoff_s")

# fold_in constants deriving the fault keys from the round key, disjoint
# from the plain core's 6-way split of the same key, so adding a fault
# model never perturbs the benign draws
_KEY_GE = 7001        # Gilbert–Elliott channel-state transitions
_KEY_CRASH = 7002     # who crashes, in which phase, how far in
_KEY_DUP = 7003       # ACK-loss duplicate deliveries
_KEY_JITTER = 7004    # reordering jitter
_KEY_RESET = 7005     # register-bank window resets
_KEY_RETRY = 7100     # + attempt index: quorum retry re-draws

_INF = float("inf")


@dataclass(frozen=True)
class FaultConfig(NetConfig):
    """A :class:`NetConfig` plus deterministic fault models and the
    degradation policies that answer them.

    All rates default to zero / the benign policy, at which point the
    chaos core is bitwise the plain packet core.  The rate fields reach
    the core through ``dyn``; ``dedup``, ``register_policy``,
    ``quorum_floor`` and ``round_retries`` shape the round itself.
    """

    # --- Gilbert–Elliott bursty loss (phase-1 vote packets): a two-state
    # channel per client; the good state loses packets at the base
    # ``loss``, the bad one at ``ge_loss_bad``; ``ge_p_gb`` / ``ge_p_bg``
    # are the per-packet good->bad / bad->good transition probabilities.
    # Phase 2 keeps the i.i.d. per-attempt ARQ model.
    ge_p_gb: float = 0.0
    ge_p_bg: float = 0.5
    ge_loss_bad: float = 1.0

    # --- client crash mid-round: a crashed client emits a strict prefix
    # of its packets and is excluded from the aggregate.  ``crash_p2_frac``
    # splits crashes between phase 1 (votes cut short, no phase 2) and
    # phase 2 (votes counted, the value upload aborts partway; the switch
    # commits none of its slots).
    crash_rate: float = 0.0
    crash_p2_frac: float = 0.5

    # --- ACK loss: the client re-sends a delivered packet one RTO later.
    # With ``dedup`` (sequence-numbered suppression) the duplicate costs
    # only wire bytes and drain time; without it the duplicate deposits a
    # second time.
    dup_rate: float = 0.0
    dedup: bool = True

    # --- reordering: uniform [0, reorder_jitter_s) added per phase-2
    # packet arrival (the drain sorts, so jitter reorders service).
    reorder_jitter_s: float = 0.0

    # --- register-bank faults: how an int32 window closes when its true
    # sum leaves the int32 range (policies.register_accumulate), and a
    # per-window reset probability (a reset window's packets are replayed
    # one RTO later; idempotent under dedup).
    register_policy: str = "wrap"
    reg_reset_rate: float = 0.0

    # --- quorum-or-abort: if fewer than ``quorum_floor`` uploaders
    # survive phase 1, the round re-runs its network phase (fresh draws,
    # same votes) after ``backoff_s * 2^attempt`` on the simulated clock,
    # up to ``round_retries`` retries; if every attempt fails the round
    # aborts.  0 disables.
    quorum_floor: int = 0
    round_retries: int = 2
    backoff_s: float = 0.1

    def __post_init__(self):
        super().__post_init__()
        for name in ("ge_p_gb", "ge_p_bg", "ge_loss_bad", "crash_rate",
                     "crash_p2_frac", "dup_rate", "reg_reset_rate"):
            check_interval(name, getattr(self, name), 0.0, 1.0)
        require(not (self.ge_p_gb > 0.0 and self.ge_p_bg <= 0.0),
                "ge_p_bg", "> 0 when ge_p_gb > 0 (the bad state must be "
                "escapable or the chain absorbs)", self.ge_p_bg)
        check_finite_at_least("reorder_jitter_s", self.reorder_jitter_s, 0.0)
        check_choice("register_policy", self.register_policy,
                     REGISTER_POLICIES)
        check_at_least("quorum_floor", self.quorum_floor, 0)
        check_at_least("round_retries", self.round_retries, 0)
        check_finite_at_least("backoff_s", self.backoff_s, 0.0)

    def retry_policy(self) -> BackoffPolicy:
        """The quorum-retry clock: exponential doubling from ``backoff_s``,
        ``round_retries`` bounded."""
        return BackoffPolicy(base_s=self.backoff_s, factor=2.0,
                             max_retries=self.round_retries)


def gilbert_elliott_stationary(p_gb: float, p_bg: float) -> float:
    """Stationary bad-state probability of the two-state chain."""
    if p_gb <= 0.0:
        return 0.0
    return p_gb / (p_gb + p_bg)


def _ge_loss_probability(key, shape, loss, p_gb, p_bg, loss_bad):
    """[N, P] per-packet loss probability under the Gilbert–Elliott chain.

    The chain (one per client, started in the good state) is driven by its
    own uniforms; the delivery comparison reuses the caller's loss
    uniforms, so at ``p_gb == 0`` every packet sees exactly
    ``float32(loss)``.  The reference steps the chain column by column; a
    step is a map of {good, bad} to itself (``f_j(good) = u_j < p_gb``,
    ``f_j(bad) = u_j >= p_bg``), and composing maps is associative, so the
    states are an inclusive prefix composition, taken here by doubling:
    ceil(log2 P) rounds of boolean selects, the same bits as the
    column-by-column chain.
    """
    u = prng.uniform(key, tuple(shape))
    dev = u.device
    from_good = u < _f32(p_gb, dev)     # F_j(good), F_j(bad): the state
    from_bad = u >= _f32(p_bg, dev)     # after packet j from each start
    step = 1
    while step < shape[1]:
        # F_j <- F_j o F_{j-step} for every j >= step
        earlier_g, earlier_b = from_good[:, :-step], from_bad[:, :-step]
        later_g, later_b = from_good[:, step:], from_bad[:, step:]
        from_good = torch.cat([from_good[:, :step],
                               torch.where(earlier_g, later_b, later_g)], 1)
        from_bad = torch.cat([from_bad[:, :step],
                              torch.where(earlier_b, later_b, later_g)], 1)
        step *= 2
    return torch.where(from_good, _f32(loss_bad, dev), _f32(loss, dev))


def _rescale_to_float(summed: torch.Tensor, shift: torch.Tensor):
    """An overflowed window comes back as mantissa x 2^shift (a sum past
    the int32 rails has no integer representation); the exponent is
    applied in float.  2^shift is built from its bits, exact.  The
    reference multiplies by ``jnp.exp2``, which under jit on XLA's CPU
    backend is exact only for shift <= 12; the shift is at most
    1 + ceil(log2 N) (``policies._rescale_shift_bound``), <= 12 for any
    N <= 2048, so the two agree there."""
    pow2 = ((shift + 127) << 23).view(torch.float32)
    return summed.to(torch.float32) * pow2


def _chaos_upload(k_arr, k_retx, k_dup, k_jit, k_reset, rates_rows, start,
                  live_slots: int, wire_bytes: int, leaf_of, svc, *,
                  loss, rto_s, max_retries: int, memory_slots: int,
                  n_leaves: int, mtu: int, not_before, up, crash_p2,
                  cut_frac, dup_rate, jitter_s, reset_rate):
    """Phase-2 reliable upload with crash prefixes, duplicates, jitter and
    register-window resets: :func:`~.batched.reliable_upload` plus the
    fault masks.

    Duplicates (ACK loss, and every packet of a reset window) are one
    extra copy of the packet arriving an RTO later: an extra ``[N, P]``
    block of columns, ``+inf`` where no duplicate exists, so the clean
    round drains the identical finite packet set.  Returns ``(DrainStats,
    n_retx, retx_last, n_win, dup_slot bool[N, live], n_dup, n_reset)``:
    crash prefixes and duplicates fold into the retransmission counts,
    which keeps the byte pricing exact (a crasher's prefix is all
    full-MTU packets, so ``retx_last`` needs no crash term).
    """
    live = max(int(live_slots), 1)
    n_win = n_windows(live, memory_slots)
    pkts = n_packets(wire_bytes, mtu)
    slots_per_pkt = -(-live // pkts)
    pkt_window = np.minimum((np.arange(pkts) * slots_per_pkt)
                            // memory_slots, n_win - 1)
    pkt_of_slot = np.minimum(np.arange(live) // slots_per_pkt, pkts - 1)
    arr = poisson_arrivals(k_arr, rates_rows, pkts, start)
    dev = arr.device
    delay, retx = retransmit_delays(k_retx, arr.shape, loss, rto_s,
                                    max_retries)
    cut = torch.floor(cut_frac * pkts).to(torch.int32)
    pkt_idx = torch.arange(pkts, dtype=torch.int32, device=dev)
    emit = up[:, None] & (~crash_p2[:, None]
                          | (pkt_idx[None, :] < cut[:, None]))
    # arr + delay + uniform * jitter is one fused multiply-add in the
    # reference (XLA contracts it); it adds +0.0 at zero jitter
    jit_u = prng.uniform(k_jit, tuple(arr.shape))
    arrd = torch.where(
        emit, xla_math.fma(jit_u, _f32(jitter_s, dev), arr + delay), _INF)
    retx = torch.where(emit, retx, 0)
    dup = prng.uniform(k_dup, tuple(arr.shape)) < _f32(dup_rate, dev)
    reset = prng.uniform(k_reset, (n_win,)) < _f32(reset_rate, dev)
    dup = (dup | reset[torch.as_tensor(pkt_window, device=dev)][None, :]) \
        & emit
    dup_arr = torch.where(dup, arrd + _f32(np.float32(rto_s), dev), _INF)
    fwd = n_packets(min(memory_slots, live) * 4, mtu)
    st = drain_hierarchy(torch.cat([arrd, dup_arr], 1), leaf_of,
                         np.concatenate([pkt_window, pkt_window]),
                         n_win, n_leaves, svc, fwd, not_before=not_before)
    crash_pkts = torch.where(up & crash_p2, cut, 0).sum(dtype=torch.int32)
    n_dup = dup.sum(dtype=torch.int32)
    n_retx = retx.sum(dtype=torch.int32) + n_dup + crash_pkts
    retx_last = (retx[:, -1].sum(dtype=torch.int32)
                 + dup[:, -1].sum(dtype=torch.int32))
    dup_slot = dup.index_select(1, torch.as_tensor(pkt_of_slot, device=dev))
    return (st, n_retx, retx_last, n_win, dup_slot, n_dup,
            reset.sum(dtype=torch.int32))


# ---------------------------------------------------------------------------
# the round's stages, shared by the chaos and the robust cores
# ---------------------------------------------------------------------------

class _Round:
    """The static geometry and configuration of one core, and the stages
    of its round; the chaos core runs them in order, the robust core
    inserts its attacks and defenses between them."""

    def __init__(self, cfg: FediACConfig, net: FaultConfig, n_clients: int):
        self.cfg, self.net, self.n = cfg, net, int(n_clients)
        self.spec = engines.resolve(cfg)
        self.leaf_of = leaf_assignment(self.n, net.n_leaves)
        self.slowdown = float(net.straggler_slowdown)
        self.f_num_host = torch.from_numpy(scale_num_table(cfg.bits, self.n))
        self.quorum = net.quorum_floor > 0
        self.n_attempts = (int(net.round_retries) + 1) if self.quorum else 1

    def open(self, u_stack, key, net_key, round_idx, rates):
        """The round's preamble at ``u_stack``'s width and device: the
        traffic, the vote and GIA packets and the packet of each chunk,
        the rates, the round key ``rk``, and the per-client vote and
        quantisation keys."""
        n_, d = u_stack.shape
        assert n_ == self.n, (n_, self.n)
        dev = u_stack.device
        n_chunks = d // self.cfg.vote_chunk
        tr = round_traffic(self.cfg, d)
        p1_pkts = n_packets(tr.phase1_bytes, self.net.mtu)
        cov = -(-n_chunks // p1_pkts)        # chunk coords per vote packet
        keys = prng.split(key, 2 * self.n)
        return SimpleNamespace(
            d=d, n_chunks=n_chunks, tr=tr, p1_pkts=p1_pkts,
            gia_pkts=n_packets(-(-n_chunks // 8), self.net.mtu),
            pkt_of_chunk=torch.as_tensor(
                np.minimum(np.arange(n_chunks) // cov, p1_pkts - 1),
                device=dev),
            rates=torch.as_tensor(rates, dtype=torch.float32, device=dev),
            rk=prng.fold_in(net_key, int(round_idx)),
            vote_keys=keys[:self.n], q_keys=keys[self.n:])

    def phase1(self, g, votes, dyn, active=None):
        """Network phase 1 of the round ``g`` (from :meth:`open`) with the
        quorum policy: sampling (gated by ``active``), vote packets under
        the GE channel, crash draws, the deadline.  ``votes`` bool[N,
        n_chunks].  Returns the selected attempt's dict, with the round's
        ``aborted``, ``attempts``, ``penalty`` (None without a quorum
        policy) and ``n_part_total`` (over every attempt made)."""
        net, n = self.net, self.n
        svc = dyn["svc"]
        rk, rates, p1_pkts = g.rk, g.rates, g.p1_pkts
        pkt_of_chunk = g.pkt_of_chunk
        dev = rates.device

        def attempt(ks):
            kp, kst, ka1, kl1, kge, kcr = ks
            part = sample_participants(kp, n, dyn["participation"])
            if active is not None:
                part = part & active
            strag = sample_stragglers(kst, part, dyn["straggler_frac"])
            slow = torch.where(strag, _f32(self.slowdown, dev), 1.0)
            train_s = dyn["local_train_s"] * slow
            eff_rates = rates / slow
            arr1 = poisson_arrivals(ka1, eff_rates, p1_pkts, train_s)
            loss_p = _ge_loss_probability(
                kge, arr1.shape, dyn["loss"], dyn["ge_p_gb"],
                dyn["ge_p_bg"], dyn["ge_loss_bad"])
            deliv = prng.uniform(kl1, tuple(arr1.shape)) >= loss_p
            kc, kph, kcut = prng.split(kcr, 3)
            crashed = prng.uniform(kc, (n,)) < dyn["crash_rate"]
            in_p2 = prng.uniform(kph, (n,)) < dyn["crash_p2_frac"]
            crash_p1 = crashed & ~in_p2
            crash_p2 = crashed & in_p2
            u_cut = prng.uniform(kcut, (n, 2))
            cut1 = torch.floor(u_cut[:, 0] * p1_pkts).to(torch.int32)
            pkt_idx = torch.arange(p1_pkts, dtype=torch.int32, device=dev)
            deliv = deliv & (~crash_p1[:, None]
                             | (pkt_idx[None, :] < cut1[:, None]))
            deliv = deliv & part[:, None]
            if net.vote_deadline_s is not None:
                deliv = deliv & deadline_mask(arr1, net.vote_deadline_s)
            chunk_ok = deliv.index_select(1, pkt_of_chunk)
            counts = (votes & chunk_ok).sum(dim=0, dtype=torch.int32)
            st1 = _masked_drain(torch.where(deliv, arr1, _INF), svc)
            t1 = torch.where(st1.n_packets > 0, st1.completion_s,
                             torch.where(part, train_s, -_INF).max())
            if net.vote_deadline_s is not None:
                t1 = torch.clamp_min(t1,
                                     float(np.float32(net.vote_deadline_s)))
            voter = chunk_ok.any(dim=1)
            up = (part & voter) if net.drop_late_voters else part
            up = up & ~crash_p1
            n_part = part.sum(dtype=torch.int32)
            return {
                "part": part, "strag": strag, "eff_rates": eff_rates,
                "counts": counts, "t1": t1, "up": up,
                "crash_p2": crash_p2, "cut2": u_cut[:, 1],
                "crashed": (crashed & part).sum(dtype=torch.int32),
                "n_part": n_part,
                "n_up": up.sum(dtype=torch.int32),
                "votes_lost": n_part * p1_pkts
                              - deliv.sum(dtype=torch.int32),
                "delivered_chunks": chunk_ok.sum(dtype=torch.int32),
            }

        k_part, k_strag, k_arr1, k_loss1 = prng.split(rk, 6)[:4]
        base = (k_part, k_strag, k_arr1, k_loss1, prng.fold_in(rk, _KEY_GE),
                prng.fold_in(rk, _KEY_CRASH))
        if not self.quorum:
            r = attempt(base)
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            r.update(aborted=zero, attempts=zero + 1, penalty=None,
                     n_part_total=r["n_part"])
            return r
        # quorum-or-abort: re-run the network phase (fresh draws from the
        # retry keys, same votes) until >= quorum_floor uploaders survive;
        # every attempt is computed and one is selected, as the reference
        # does, so nothing is read back
        results = [attempt(base)]
        for i in range(1, self.n_attempts):
            results.append(attempt(tuple(prng.split(
                prng.fold_in(rk, _KEY_RETRY + i), 6))))
        stacked = {k: torch.stack([r[k] for r in results])
                   for k in results[0]}
        ok = stacked["n_up"] >= int(net.quorum_floor)
        ok_any = ok.any()
        sel = torch.where(ok_any, torch.argmax(ok.to(torch.int32)),
                          self.n_attempts - 1).to(torch.int32)
        idx = torch.arange(self.n_attempts, dtype=torch.int32, device=dev)
        backoff = net.retry_policy().delays(self.n_attempts,
                                            base=dyn["backoff_s"])
        penalty = _sum_in_order(torch.where(idx < sel,
                                            stacked["t1"] + backoff, 0.0))
        n_part_total = torch.where(idx <= sel, stacked["n_part"],
                                   0).sum(dtype=torch.int32)
        r = {k: _at(v, sel) for k, v in stacked.items()}
        r.update(aborted=(~ok_any).to(torch.int32), attempts=sel + 1,
                 penalty=penalty, n_part_total=n_part_total)
        return r

    def start2(self, g, r):
        """Phase 2's start: phase 1's close, the GIA broadcast, and the
        backoff of failed quorum attempts."""
        start2 = r["t1"] + download_time(g.gia_pkts, g.rates)
        if r["penalty"] is not None:
            start2 = start2 + r["penalty"]
        return start2

    def upload(self, g, r, start2, c_live, dyn):
        """Phase 2 through the register bank, with faults."""
        net, rk = self.net, g.rk
        k_arr2, k_retx = prng.split(rk, 6)[4:]
        return _chaos_upload(
            k_arr2, k_retx, prng.fold_in(rk, _KEY_DUP),
            prng.fold_in(rk, _KEY_JITTER), prng.fold_in(rk, _KEY_RESET),
            r["eff_rates"], start2, c_live, g.tr.phase2_bytes, self.leaf_of,
            dyn["svc"], loss=dyn["loss"], rto_s=net.rto_s,
            max_retries=net.max_retries, memory_slots=net.memory_slots,
            n_leaves=net.n_leaves, mtu=net.mtu, not_before=start2,
            up=r["up"], crash_p2=r["crash_p2"], cut_frac=r["cut2"],
            dup_rate=dyn["dup_rate"], jitter_s=dyn["reorder_jitter_s"],
            reset_rate=dyn["reg_reset_rate"])

    def commit(self, r):
        """All-or-nothing per client: a phase-2 crasher commits none of
        its slots, an aborted round commits nobody (delta 0, residuals
        fall back to u).  Returns ``(committed, n_commit)``."""
        committed = r["up"] & ~r["crash_p2"]
        if self.quorum:
            committed = committed & (r["aborted"] == 0)
        return committed, committed.sum(dtype=torch.int32)

    def register_close(self, q, committed, dup_slot, n_win):
        """The §14 register-window close of the committed rows: duplicate
        deposits without dedup, the overflow policy, the rescale exponent
        applied in float.  Returns ``(summed, overflowed slots)``."""
        net = self.net
        rows = torch.where(committed[:, None], q, 0)
        if not net.dedup:
            # no duplicate suppression: every duplicated packet's slots
            # deposit a second time
            rows = rows + torch.where(committed[:, None] & dup_slot, q, 0)
        c_live = q.shape[1]
        summed, ovf, shift = register_accumulate(
            rows, policy=net.register_policy,
            slot_window=slot_window(c_live, net.memory_slots),
            n_windows=n_win)
        if net.register_policy == "rescale":
            summed = _rescale_to_float(summed, shift)
        return summed, ovf.sum(dtype=torch.int32)

    def aux(self, g, r, committed, n_commit, up_res, start2, c_live,
            n_overflow):
        """The round's wall clock and accounting, the plain core's keys
        plus the chaos extras."""
        net = self.net
        dev = committed.device
        st2, n_retx, retx_last, n_win, _, n_dup, n_reset = up_res
        t1 = r["t1"]
        t2 = torch.maximum(st2.completion_s, start2)
        wall2 = t2 + download_time(n_packets(g.tr.phase2_bytes, net.mtu),
                                   g.rates)
        wall = torch.where(n_commit > 0, wall2, start2)
        value_ops = _value_ops(committed, self.leaf_of, net.n_leaves, c_live)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return {
            "participants": r["part"], "stragglers": r["strag"],
            "uploaders": committed, "counts": r["counts"],
            "n_part": r["n_part_total"], "n_up": n_commit,
            "n_strag": r["strag"].sum(dtype=torch.int32),
            "votes_lost": r["votes_lost"],
            "retransmissions": n_retx, "retx_last": retx_last,
            "wall_clock_s": wall, "phase1_s": t1,
            "phase2_s": t2 - t1,
            "mean_wait_s": st2.mean_wait_s,
            "aggregation_ops": r["delivered_chunks"]
                               + torch.where(n_commit > 0, value_ops, zero),
            "peak_live_slots": torch.where(
                n_commit > 0, zero + min(net.memory_slots, c_live), zero),
            "passes": n_win,
            # chaos extras (stats only)
            "crashed": r["crashed"],
            "duplicates": n_dup, "resets": n_reset,
            "overflow_slots": n_overflow,
            "aborted": r["aborted"], "attempts": r["attempts"],
        }


def make_chaos_packet_core(cfg: FediACConfig, net: FaultConfig,
                           n_clients: int):
    """Build the fault-injected FediAC packet round.

    Same contract as :func:`repro_torch.netsim.batched.make_fediac_packet_core`
    — ``core(u_stack, key, net_key, round_idx, rates, dyn)`` returning
    ``(delta, residuals, aux)`` on ``u_stack``'s device — with ``dyn``
    extended by the :data:`FAULT_DYN_FIELDS` rates
    (:func:`chaos_packet_dyn`).  ``aux`` keeps every plain-core key with
    the same accounting (crash prefixes, duplicates and reset replays fold
    into ``retransmissions``; failed quorum attempts into ``n_part``;
    ``n_up`` is the *committed* uploader count) plus the chaos extras of
    :data:`CHAOS_STAT_FIELDS`.
    """
    rnd = _Round(cfg, net, n_clients)

    def core(u_stack, key, net_key, round_idx, rates, dyn):
        g = rnd.open(u_stack, key, net_key, round_idx, rates)
        votes = client_vote_stack(u_stack, cfg, g.vote_keys).to(torch.bool)
        r = rnd.phase1(g, votes, dyn)
        del votes

        # the GIA broadcast precedes phase-2 crashes: f and a come from the
        # announced uploader set
        f, _, plan, q_bufs, res = _gia_compress(
            cfg, rnd.spec, rnd.n, rnd.f_num_host, u_stack, r["up"],
            r["n_up"], r["counts"], g.q_keys, dyn)
        start2 = rnd.start2(g, r)
        c_live = q_bufs.shape[1]
        up_res = rnd.upload(g, r, start2, c_live, dyn)

        committed, n_commit = rnd.commit(r)
        summed, n_overflow = rnd.register_close(q_bufs, committed,
                                                up_res[4], up_res[3])
        delta = _scatter_delta(cfg, summed, plan, g.d, n_commit, f,
                               n_commit)
        residuals = torch.where(committed[:, None], res, u_stack)
        del res
        aux = rnd.aux(g, r, committed, n_commit, up_res, start2, c_live,
                      n_overflow)
        return delta, residuals, aux

    return core


def chaos_packet_dyn(cfg: FediACConfig, net: FaultConfig, n_clients: int,
                     local_train_s: float, svc: float, device=None) -> dict:
    """The ``dyn`` dict of one chaos scenario: the benign
    :func:`~repro_torch.netsim.batched.packet_dyn` scalars plus the fault
    rates, on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    dyn = packet_dyn(cfg, net, n_clients, local_train_s, svc, device=dev)
    for name in FAULT_DYN_FIELDS[len(PACKET_DYN_FIELDS):]:
        dyn[name] = _f32(getattr(net, name), dev)
    return dyn
