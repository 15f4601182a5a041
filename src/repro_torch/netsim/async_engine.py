"""The asynchronous quorum-or-deadline round close.

The synchronous packet round (:mod:`.batched`) is a lockstep: the switch
waits for every phase-2 uploader before it closes, so one straggler stalls
the fleet.  Here the clients' phase-2 payloads arrive on the same keyed
packet timelines, the switch folds value packets into the register bank
as they land (event order: int32 addition is associative and commutative
mod 2^32), and the round closes on **quorum or deadline**:

* *quorum*: the round may close once ``quorum_frac`` of the announced
  uploaders have fully landed;
* *deadline*: with ``round_deadline_s`` set, the round closes at
  ``phase2_start + round_deadline_s`` even if the quorum is short.

An update that lands after the close is never dropped: under
``late_policy="fold"`` it is carried, staleness-weighted, into the next
round's aggregate through the ``carry`` buffer; under ``"bounce"`` (or
past the ``"cap"`` mode's ``staleness_cap``) it returns whole to the
client's error-feedback residual, as a non-uploader's does.  Staleness
weights are constant, polynomial ``(1 + s) ** -gamma``, or constant with a
hard cap.

The carry (a dict of float32 ``pending``, float32 ``pending_w`` and int32
``pending_n``) rides ``RoundResult.state``, which the FL loop threads and
checkpoints as ``agg_state``, so kill-and-resume needs nothing new.

With full quorum, no deadline and an empty carry the round is bitwise the
synchronous packet round, and so ``aggregate_stack`` in the lossless
full-participation configuration: phase 1, the GIA and phase-2
compression are the plain core's own helpers (``batched._phase1``,
``_gia_compress``, ``upload_schedule``), and every departure from lockstep
is a ``where`` away from the synchronous expression.  Only the close is
new: per-packet departures from the windowed FIFO drain, the
quorum-or-deadline ``t_close`` and the staleness-weighted carry.  It runs
on every engine the plain core runs on.

Floating-point forms the reference's compiled round fixes, held here
bitwise: the drain's tie order (a stable sort), the quorum count in
float32 rounded half to even, the poly weight through XLA's ``pow``
(:func:`repro_torch.core.xla_math.pow`), 2^shift of the rescale close
built from its bits, the late buffer's weighted client sum as in-order
fused multiply-adds, and every division tensor by tensor.  The mean wait
is a float sum in another order (within 1e-6, as the plain round's).

:func:`aggregate_async_stack` is the in-memory ``"async"`` engine: the
stacked round with the register fold in a random event order, bitwise
``aggregate_stack``.  :class:`AsyncServer` is the close run eagerly on the
host, one completion event at a time, over the serving admission queue;
it is the oracle the tensor close is held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engines, prng, xla_math
from repro_torch.core.fediac import (FediACConfig, aggregate_from_counts,
                                     client_vote_stack, round_traffic)
from repro_torch.core.robust_agg import client_sum
from repro_torch.serving.admission import AdmissionQueue
from repro_torch.switch import n_packets
from repro_torch.validate import (check_choice, check_finite_at_least,
                                  check_interval, check_positive_finite,
                                  require)

from .batched import (PACKET_DYN_FIELDS, _at, _gia_compress, _phase1,
                      _scatter_slots, packet_dyn, scale_num_table,
                      upload_schedule)
from .dataplane import DataplaneStats, slot_window
from .faults import _rescale_to_float
from .policies import (NetConfig, REGISTER_POLICIES, _f32,
                       register_accumulate)
from .timeline import _sum_in_order, download_time, mg1_departures

__all__ = ["AsyncConfig", "ASYNC_DYN_FIELDS", "ASYNC_STAT_FIELDS",
           "STALENESS_MODES", "LATE_POLICIES", "make_async_packet_core",
           "async_packet_dyn", "init_async_carry", "aggregate_async_stack",
           "AsyncServer"]

#: staleness-weight schedules for updates that straddle the round close
STALENESS_MODES = ("constant", "poly", "cap")

#: what happens to an update that lands after the close (never: dropped)
LATE_POLICIES = ("fold", "bounce")

#: the async-only aux scalars on top of the plain core's (``PacketTransport``
#: folds exactly these into its stats dict)
ASYNC_STAT_FIELDS = ("late_folded", "late_bounced", "folded_in",
                     "staleness_s_sum", "buffer_occupancy", "carry_weight",
                     "quorum_met")

#: the per-scenario round-close knobs, appended to PACKET_DYN_FIELDS
ASYNC_DYN_FIELDS = PACKET_DYN_FIELDS + (
    "quorum_frac", "round_deadline_s", "staleness_weight",
    "staleness_gamma", "staleness_cap")

# fold_in constant deriving the event-order key of the in-memory engine,
# disjoint from the packet core's splits and the fault keys (7001-7100)
_KEY_ARRIVAL = 7300

_INF = float("inf")


@dataclass(frozen=True)
class AsyncConfig(NetConfig):
    """A :class:`NetConfig` plus the quorum-or-deadline round-close policy.

    At the defaults (full quorum, no deadline, weight 1) the async core is
    bitwise the synchronous packet core.  The scalar knobs
    (``quorum_frac``, ``round_deadline_s``'s value, ``staleness_weight`` /
    ``gamma`` / ``cap``) reach the core through ``dyn``;
    ``staleness_mode``, ``late_policy``, ``register_policy`` and the
    presence of a deadline shape the round itself.
    """

    # --- round close: the switch may close once round(quorum_frac * n_up)
    # uploaders have fully landed, and must close at phase2_start +
    # round_deadline_s if one is set (None = quorum only).
    quorum_frac: float = 1.0
    round_deadline_s: float | None = None

    # --- staleness-weighted merging of updates that straddle the close:
    # "constant" folds each late update at weight staleness_weight;
    # "poly" decays with relative staleness s as (1 + s) ** -gamma;
    # "cap" folds at staleness_weight while s <= staleness_cap and
    # bounces beyond it.
    staleness_mode: str = "constant"
    staleness_weight: float = 1.0
    staleness_gamma: float = 1.0
    staleness_cap: float = 4.0

    # --- what a late update becomes: "fold" carries it (weighted) into
    # the next round's aggregate; "bounce" returns it to the client's
    # error-feedback residual.  Neither drops it.
    late_policy: str = "fold"

    # --- how the register bank closes an overflowing window
    register_policy: str = "wrap"

    def __post_init__(self):
        super().__post_init__()
        check_interval("quorum_frac", self.quorum_frac, 0.0, 1.0,
                       lo_open=True)
        if self.round_deadline_s is not None:
            check_positive_finite("round_deadline_s", self.round_deadline_s)
        check_choice("staleness_mode", self.staleness_mode, STALENESS_MODES)
        check_interval("staleness_weight", self.staleness_weight, 0.0, 1.0,
                       lo_open=True)
        check_finite_at_least("staleness_gamma", self.staleness_gamma, 0.0)
        check_finite_at_least("staleness_cap", self.staleness_cap, 0.0)
        check_choice("late_policy", self.late_policy, LATE_POLICIES)
        check_choice("register_policy", self.register_policy,
                     REGISTER_POLICIES)
        require(self.n_leaves == 1, "n_leaves",
                "== 1 (the async engine closes rounds at a single switch)",
                self.n_leaves)


def init_async_carry(d: int, device=None) -> dict:
    """The empty carry buffer, on ``device`` (the card unless told
    otherwise): no pending late updates."""
    dev = resolve_device(device)
    return {"pending": torch.zeros(int(d), dtype=torch.float32, device=dev),
            "pending_w": torch.zeros((), dtype=torch.float32, device=dev),
            "pending_n": torch.zeros((), dtype=torch.int32, device=dev)}


def _per_packet_departures(arrd: torch.Tensor, pkt_window: np.ndarray,
                           n_win: int, svc, not_before):
    """The windowed FIFO drain with every packet's departure kept.

    The arithmetic of ``timeline.windowed_drain`` (each window's arrivals
    clamped to its open time, sorted, the mg1 recursion, the wait sums),
    read out per packet: the event feed of the close.  The sort is stable:
    after the first window many arrivals tie at the window's open time and
    every masked packet is ``+inf``, and the departures are sequential, so
    the order among ties decides each packet's departure.  Returns ``(dep
    [N, P], completion, mean_wait, n_packets)``; a masked (+inf) packet
    departs at +inf.
    """
    n = arrd.shape[0]
    dev = arrd.device
    dep = torch.full(arrd.shape, _INF, dtype=torch.float32, device=dev)
    t_free = _f32(not_before, dev)
    wait_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_tot = torch.zeros((), dtype=torch.int32, device=dev)
    pkt_window = np.asarray(pkt_window)
    for w in range(int(n_win)):
        cols = np.flatnonzero(pkt_window == w)
        if cols.size == 0:
            continue
        cols_t = torch.as_tensor(cols, device=dev)
        a_w = torch.maximum(arrd.index_select(1, cols_t), t_free).reshape(-1)
        a_sorted, order = torch.sort(a_w, stable=True)
        d_sorted = mg1_departures(a_sorted, svc, assume_sorted=True)
        d_w = torch.empty_like(d_sorted).scatter_(0, order, d_sorted)
        dep[:, cols_t] = d_w.reshape(n, cols.size)
        live = torch.isfinite(a_sorted)
        n_w = live.sum(dtype=torch.int32)
        waits = torch.where(live, d_sorted - a_sorted - svc, 0.0)
        mean_w = waits.sum() / torch.clamp_min(n_w, 1)
        t_free = torch.where(n_w > 0, torch.where(live, d_sorted, -_INF).max(),
                             t_free)
        wait_sum = wait_sum + mean_w * n_w
        n_tot = n_tot + n_w
    return dep, t_free, wait_sum / torch.clamp_min(n_tot, 1), n_tot


def _quorum_count(quorum_frac: torch.Tensor, n_up: torch.Tensor):
    """The uploaders the quorum waits for: ``round(quorum_frac * n_up)``
    computed in float32 and rounded half to even (as the reference does;
    a float64 product rounds differently at, e.g., 0.59 x 50), clipped to
    ``[1, max(n_up, 1)]``."""
    one = torch.ones((), dtype=torch.int32, device=n_up.device)
    qn = torch.round(quorum_frac * n_up.to(torch.float32)).to(torch.int32)
    return torch.minimum(torch.maximum(qn, one), torch.maximum(n_up, one))


def _weighted_client_sum(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum(q * w[:, None], axis=0)`` over the client rows as the
    reference's compiled round takes it: from +0.0, in client order, each
    product and sum one fused multiply-add."""
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for i in range(q.shape[0]):
        acc = xla_math.fma(q[i].to(torch.float32), w[i], acc)
    return acc


def make_async_packet_core(cfg: FediACConfig, net: AsyncConfig,
                           n_clients: int):
    """Build the async FediAC packet round.

    ``core(u_stack, carry, key, net_key, round_idx, rates, dyn)`` returns
    ``(delta, residuals, aux, new_carry)`` on ``u_stack``'s device; ``dyn``
    is the plain core's dict extended by the :data:`ASYNC_DYN_FIELDS`
    knobs (:func:`async_packet_dyn`).  ``aux`` keeps every plain-core key
    (``n_up`` is the committed on-time uploader count; ``n_up_wire`` the
    announced one, which prices the wire bytes), the
    :data:`ASYNC_STAT_FIELDS` extras, ``overflow_slots``, and the
    per-client completion times ``t_done`` and the close ``t_close``.
    """
    spec = engines.resolve(cfg)
    n = int(n_clients)
    f_num_host = torch.from_numpy(scale_num_table(cfg.bits, n))
    bounce_all = net.late_policy == "bounce"

    def core(u_stack, carry, key, net_key, round_idx, rates, dyn):
        g = _phase1(cfg, net, n, u_stack, key, net_key, round_idx, rates,
                    dyn)
        up, n_up, d = g.up, g.n_up, g.d
        dev = u_stack.device

        # ---- GIA + phase-2 compress: the plain core's helper.
        f, _, plan, q_bufs, res = _gia_compress(
            cfg, spec, n, f_num_host, u_stack, up, n_up, g.counts, g.q_keys,
            dyn)

        # ---- the phase-2 event feed: the plain core's upload schedule
        # through one switch's windows, each packet's departure kept.
        c_live = q_bufs.shape[1]
        start2 = g.t1 + g.t_gia
        arrd, retx, pkt_window, n_win = upload_schedule(
            g.k_arr2, g.k_retx, g.eff_rates, start2, c_live,
            g.tr.phase2_bytes, loss=dyn["loss"], rto_s=net.rto_s,
            max_retries=net.max_retries, memory_slots=net.memory_slots,
            mtu=net.mtu, row_mask=up)
        dep, _, mean_wait, _ = _per_packet_departures(
            arrd, pkt_window, n_win, g.svc, start2)
        t_done = dep.amax(dim=1)           # +inf for non-uploaders

        # ---- quorum-or-deadline close.
        qn = _quorum_count(dyn["quorum_frac"], n_up)
        t_quorum = _at(torch.sort(torch.where(up, t_done, _INF)).values,
                       qn - 1)
        if net.round_deadline_s is not None:
            t_deadline = start2 + dyn["round_deadline_s"]
            t_close = torch.minimum(t_quorum, t_deadline)
            quorum_met = (t_quorum <= t_deadline).to(torch.int32)
        else:
            t_close = t_quorum
            quorum_met = torch.ones((), dtype=torch.int32, device=dev)
        on_time = up & (t_done <= t_close)
        late = up & ~on_time
        n_on = on_time.sum(dtype=torch.int32)

        # ---- staleness weights for the stragglers.
        s = (t_done - t_close) / torch.clamp_min(t_close, _f32(1e-9, dev))
        if net.staleness_mode == "poly":
            w = xla_math.pow(1.0 + torch.clamp_min(s, 0.0),
                             -dyn["staleness_gamma"])
        else:
            w = dyn["staleness_weight"].expand(s.shape)
        fold_ok = torch.zeros_like(late) if bounce_all else late
        if net.staleness_mode == "cap" and not bounce_all:
            fold_ok = fold_ok & (s <= dyn["staleness_cap"])
        late_fold = late & fold_ok
        late_bounce = late & ~fold_ok
        w_late = torch.where(late_fold, w, 0.0)

        # ---- close the register bank over the on-time rows; wrap is the
        # masked int32 sum of the plain core.
        rows = torch.where(on_time[:, None], q_bufs, 0)
        summed, reg_ovf, reg_shift = register_accumulate(
            rows, policy=net.register_policy,
            slot_window=slot_window(c_live, net.memory_slots),
            n_windows=n_win)
        if net.register_policy == "rescale":
            summed = _rescale_to_float(summed, reg_shift)
        scat = _scatter_slots(cfg, summed, plan, d)
        # base is the synchronous formula; the carry fold is a where away
        # from it, so an empty carry never relies on x + 0.0 == x
        base = scat / (torch.clamp_min(n_on, 1) * f)
        pending_in = carry["pending"].to(torch.float32)
        w_in = carry["pending_w"].to(torch.float32)
        n_in = carry["pending_n"].to(torch.int32)
        has_carry = n_in > 0
        folded = (scat / f + pending_in) / torch.clamp_min(
            n_on.to(torch.float32) + w_in, _f32(1e-9, dev))
        delta = torch.where(has_carry, folded, base)
        applied = (n_on > 0) | has_carry
        delta = torch.where(applied, delta, 0.0)

        # ---- late folds feed the next round's carry, in update units
        # (dequantized by this round's f, staleness-weighted).
        late_buf = _weighted_client_sum(q_bufs, w_late)
        n_fold = late_fold.sum(dtype=torch.int32)
        w_sum = _sum_in_order(w_late)
        new_carry = {"pending": _scatter_slots(cfg, late_buf, plan, d) / f,
                     "pending_w": w_sum, "pending_n": n_fold}

        # an on-time or folded client's update is in flight (aggregate or
        # carry), so its residual advances; a bounced one keeps its whole
        # update, as a non-uploader does
        keep_upd = on_time | late_fold
        residuals = torch.where(keep_upd[:, None], res, u_stack)
        del res

        # ---- clocks and accounting: the plain formulas over the close.
        t2 = torch.where(n_up > 0, torch.maximum(t_close, start2), start2)
        wall2 = t2 + download_time(n_packets(g.tr.phase2_bytes, net.mtu),
                                   g.rates)
        wall = torch.where(applied, wall2, start2)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        value_ops = torch.clamp_min(n_on - 1, 0) * c_live
        aux = {
            "participants": g.part, "stragglers": g.strag,
            "uploaders": on_time, "counts": g.counts,
            "n_part": g.n_part, "n_up": n_on, "n_up_wire": n_up,
            "n_strag": g.n_strag, "votes_lost": g.votes_lost,
            "retransmissions": retx.sum(dtype=torch.int32),
            "retx_last": retx[:, -1].sum(dtype=torch.int32),
            "wall_clock_s": wall, "phase1_s": g.t1,
            "phase2_s": t2 - g.t1,
            "mean_wait_s": mean_wait,
            "aggregation_ops": g.delivered_chunks
                               + torch.where(n_on > 0, value_ops, zero),
            "peak_live_slots": torch.where(
                n_on > 0, zero + min(net.memory_slots, c_live), zero),
            "passes": n_win,
            "late_folded": n_fold,
            "late_bounced": late_bounce.sum(dtype=torch.int32),
            "folded_in": n_in,
            "staleness_s_sum": _sum_in_order(torch.where(late, s, 0.0)),
            "buffer_occupancy": n_fold,
            "carry_weight": w_sum,
            "quorum_met": quorum_met,
            "overflow_slots": reg_ovf.sum(dtype=torch.int32),
            "t_done": t_done, "t_close": t_close,
        }
        return delta, residuals, aux, new_carry

    return core


def async_packet_dyn(cfg: FediACConfig, net: AsyncConfig, n_clients: int,
                     local_train_s: float, svc: float, device=None) -> dict:
    """The ``dyn`` dict of one async scenario: the plain
    :func:`~repro_torch.netsim.batched.packet_dyn` scalars plus the
    round-close knobs, on ``device`` (the card unless told otherwise)."""
    dyn = packet_dyn(cfg, net, n_clients, local_train_s, svc, device=device)
    dev = dyn["loss"].device
    deadline = net.round_deadline_s
    dyn.update({
        "quorum_frac": _f32(net.quorum_frac, dev),
        "round_deadline_s": _f32(deadline if deadline is not None else 0.0,
                                 dev),
        "staleness_weight": _f32(net.staleness_weight, dev),
        "staleness_gamma": _f32(net.staleness_gamma, dev),
        "staleness_cap": _f32(net.staleness_cap, dev),
    })
    return dyn


# ---------------------------------------------------------------------------
# The in-memory "async" engine (core/engines.py registry)
# ---------------------------------------------------------------------------

def _event_fold(rows: torch.Tensor) -> torch.Tensor:
    """Fold rows into the register bank one event at a time, the switch's
    incremental accumulation; bitwise ``rows.sum(0)`` for integer rows."""
    acc = torch.zeros(rows.shape[1:], dtype=rows.dtype, device=rows.device)
    for row in rows:
        acc = acc + row
    return acc


def aggregate_async_stack(u_stack: torch.Tensor, cfg: FediACConfig,
                          key: torch.Tensor, *, a=None):
    """One stacked FediAC round with event-ordered incremental folding.

    The :func:`~repro_torch.core.fediac.aggregate_stack` signature and
    return contract, and bitwise its result: the clients' phase-2 buffers
    arrive in a random order (a permutation drawn from ``fold_in(key,
    7300)``, stably sorted) and fold into the bank one at a time.  Under a
    robust close the bank buffers every client before closing, so the
    close is ``client_sum`` over the unpermuted stack (ties break by
    client index, not arrival order).
    """
    n, d = u_stack.shape
    vote_keys = prng.split(key, 2 * n)[:n]
    counts = client_vote_stack(u_stack, cfg, vote_keys).sum(
        dim=0, dtype=torch.int32)
    perm = torch.sort(prng.uniform(prng.fold_in(key, _KEY_ARRIVAL), (n,)),
                      stable=True).indices

    def close(q):
        if cfg.robust_agg == "sum":
            return _event_fold(q.index_select(0, perm)), n
        return client_sum(q, cfg)

    delta, residuals = aggregate_from_counts(u_stack, cfg, key, counts, a=a,
                                             close=close)
    return delta, residuals, counts, round_traffic(cfg, d)


# ---------------------------------------------------------------------------
# The eager host reference: the round-close state machine on the admission
# queue, the oracle the tensor close is held against
# ---------------------------------------------------------------------------

class AsyncServer:
    """Event-driven round-close reference over an
    :class:`~repro_torch.serving.admission.AdmissionQueue` slot pool.

    The packet core resolves the quorum-or-deadline close as fixed-shape
    mask algebra; this class is the same state machine run eagerly, one
    completion event at a time — on-time updates fold and free their slot
    immediately, late folds occupy a slot (the carry buffer) until the
    *next* round consumes them, bounces never admit.  Slot occupancy and
    the late-fold/late-bounce counters land in a
    :class:`~repro_torch.netsim.dataplane.DataplaneStats`.
    """

    def __init__(self, net: AsyncConfig, n_slots: int = 64):
        self.net = net
        self.queue = AdmissionQueue(n_slots)
        self.stats = DataplaneStats(passes=0)

    def close_time(self, t_done: np.ndarray, start: float) -> float:
        """Quorum-or-deadline close of one round's completion events
        (``+inf`` = absent client) — the host mirror of the tensor rule."""
        t = np.asarray(t_done, np.float32)
        finite = np.isfinite(t)
        n_up = int(finite.sum())
        if n_up == 0:
            t_quorum = np.inf
        else:
            qn = min(max(1, round(self.net.quorum_frac * n_up)), n_up)
            t_quorum = float(np.sort(t[finite])[qn - 1])
        if self.net.round_deadline_s is None:
            return t_quorum
        return min(t_quorum, float(start) + self.net.round_deadline_s)

    def run_round(self, t_done: np.ndarray, start: float = 0.0) -> dict:
        """Process one round's completion events in time order.

        Returns ``{"t_close", "on_time", "late_fold", "late_bounce",
        "folded_in", "occupancy"}``; ``folded_in`` is the number of
        carried-over updates from earlier rounds consumed at this close.
        """
        t = np.asarray(t_done, np.float32)
        t_close = self.close_time(t, start)
        folded_in = self.queue.n_active
        for slot, _ in list(self.queue.active()):
            self.queue.release(slot)      # carried updates fold at close
        on_time = np.isfinite(t) & (t <= t_close)
        late = np.isfinite(t) & ~on_time
        s = (t - t_close) / max(t_close, 1e-9)
        if self.net.late_policy == "bounce":
            fold_ok = np.zeros_like(late)
        elif self.net.staleness_mode == "cap":
            fold_ok = late & (s <= self.net.staleness_cap)
        else:
            fold_ok = late
        late_fold = late & fold_ok
        late_bounce = late & ~fold_ok
        for i in np.argsort(t, kind="stable"):
            if not np.isfinite(t[i]) or not late_fold[i]:
                continue
            self.queue.submit(int(i))
            self.queue.admit()            # occupies a slot until next close
        self.stats = self.stats.merge(DataplaneStats(
            passes=0, late_folds=int(late_fold.sum()),
            late_bounces=int(late_bounce.sum())))
        return {"t_close": t_close, "on_time": on_time,
                "late_fold": late_fold, "late_bounce": late_bounce,
                "folded_in": folded_in,
                "occupancy": self.queue.n_active}
