"""The fixed-shape packet round core.

``make_fediac_packet_core`` builds one FediAC packet round as a plain
function of tensors — participant sampling, stragglers, Poisson vote
packets with loss and the quorum deadline, the GIA, phase-2 compression,
ARQ'd value packets through the register-window / leaf->root hierarchy
drains, and the simulated wall-clock — with every data-dependent quantity
expressed as a masked fixed-``[N]`` formulation, so the round runs on the
device without reading anything back:

* participant/straggler/uploader selection returns boolean masks, never
  index arrays; absent clients' packets are ``+inf`` arrivals
  (``timeline``'s masking convention) and their value rows are
  ``where``-masked out of the integer aggregate;
* the ``n_up == 0`` round is the same program under a ``where``: the
  uploader mask is all-False, so the residual stack falls back to ``u``
  and the delta to zeros exactly;
* quantities the host resolves from the data-dependent uploader count
  (the vote threshold ``a = cfg.threshold(n_up)`` and the quantization
  numerator ``2^{b-1} - n_up``) are host-side ``[N+1]`` lookup tables
  gathered at the device's ``n_up``.

All network randomness derives from ``policies.net_round_key(seed,
round_idx)``; the model randomness (votes, stochastic quantization) uses
the FL loop's round key exactly as ``aggregate_stack`` does, so the
lossless full-participation round is bitwise the in-memory round on every
engine.  The scenario knobs — loss, participation, straggler fraction,
local train time, switch service time and the threshold table — enter
through the ``dyn`` dict (:func:`packet_dyn`).

``reliable_upload`` (phase-2 scheduling: packet->window map, Poisson
arrivals, ARQ delays, hierarchical drain) is shared with the baseline
packet path in ``transport.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import compaction, engines, prng
from repro_torch.core.fediac import (FediACConfig, build_round_plan,
                                     client_vote_stack, phase2_compress,
                                     plan_wants_dense_mask, round_traffic,
                                     scatter_sum)
from repro_torch.core.shard_engine import shard_compress_stack
from repro_torch.core.stream_engine import stream_compress_stack
from repro_torch.switch import n_packets, packet_sizes

from .dataplane import n_windows
from .hierarchy import drain_hierarchy, leaf_assignment
from .policies import NetConfig, sample_participants, sample_stragglers
from .timeline import (_masked_drain, deadline_mask, download_time,
                       lose_packets, poisson_arrivals, retransmit_delays)

__all__ = ["threshold_table", "scale_num_table", "upload_schedule",
           "reliable_upload", "retx_byte_count", "make_fediac_packet_core",
           "packet_dyn", "PACKET_DYN_FIELDS"]

#: the per-scenario scalars of one packet round, as :func:`packet_dyn`
#: builds them
PACKET_DYN_FIELDS = ("a_table", "loss", "participation", "straggler_frac",
                     "local_train_s", "svc")

_INF = float("inf")


def threshold_table(cfg: FediACConfig, n_clients: int) -> np.ndarray:
    """int32[N+1] — ``cfg.threshold(m)`` for every possible uploader count
    m (m = 0 maps to 1): the core gathers the host's exact threshold at
    the round's ``n_up`` instead of re-deriving ``ceil(a_frac * n_up)`` in
    float32."""
    return np.array([1] + [cfg.threshold(m) for m in range(1, n_clients + 1)],
                    np.int32)


def scale_num_table(bits: int, n_clients: int) -> np.ndarray:
    """float32[N+1] — the quantization numerator ``2^{b-1} - m`` over ``m``
    for every uploader count, computed in float64 then cast, as the host
    path's ``scale_factor(bits, m, 1.0)`` is."""
    return np.array([1.0] + [(2.0 ** (bits - 1) - m) / m
                             for m in range(1, n_clients + 1)], np.float32)


def upload_schedule(k_arr, k_retx, rates_rows, start, live_slots: int,
                    wire_bytes: int, *, loss, rto_s, max_retries: int,
                    memory_slots: int, mtu: int, row_mask=None):
    """The packets of one reliable upload before any drain: the packet ->
    register-window map (host), the Poisson arrivals plus ARQ delays
    (``+inf`` on rows outside ``row_mask``) and the retransmission counts.
    Returns ``(arrivals [N, P], retx int32[N, P], packet_window, n_win)``.
    """
    live = max(int(live_slots), 1)
    n_win = n_windows(live, memory_slots)
    pkts = n_packets(wire_bytes, mtu)
    slots_per_pkt = -(-live // pkts)
    pkt_window = np.minimum((np.arange(pkts) * slots_per_pkt)
                            // memory_slots, n_win - 1)
    arr = poisson_arrivals(k_arr, rates_rows, pkts, start)
    delay, retx = retransmit_delays(k_retx, arr.shape, loss, rto_s,
                                    max_retries)
    if row_mask is not None:
        arr = torch.where(row_mask[:, None], arr, _INF)
        retx = torch.where(row_mask[:, None], retx, 0)
    return arr + delay, retx, pkt_window, n_win


def reliable_upload(k_arr, k_retx, rates_rows, start, live_slots: int,
                    wire_bytes: int, leaf_of: np.ndarray, svc, *,
                    loss, rto_s, max_retries: int, memory_slots: int,
                    n_leaves: int, mtu: int, not_before=0.0, row_mask=None):
    """Schedule one reliable upload through the register windows — packet->
    window map, Poisson arrivals, ARQ delays (:func:`upload_schedule`),
    hierarchical drain — shared by the FediAC phase 2 (full rows +
    ``row_mask``) and the baseline path (pre-filtered subset rows,
    ``row_mask=None``).  On the keys' device.

    Returns ``(DrainStats, retransmission count, retransmissions of the
    final partial packet, window count)``; the counts are int32 0-d
    tensors.  The retransmitted *bytes* are reconstructed on the host by
    :func:`retx_byte_count` — every packet but the last is MTU-sized, so
    two bounded int32 counts carry the exact figure without an int32 byte
    sum that would wrap at ~2.1 GB of retransmissions.
    """
    arrd, retx, pkt_window, n_win = upload_schedule(
        k_arr, k_retx, rates_rows, start, live_slots, wire_bytes, loss=loss,
        rto_s=rto_s, max_retries=max_retries, memory_slots=memory_slots,
        mtu=mtu, row_mask=row_mask)
    fwd = n_packets(min(memory_slots, max(int(live_slots), 1)) * 4, mtu)
    st = drain_hierarchy(arrd, leaf_assignment(arrd.shape[0], n_leaves)
                         if leaf_of is None else leaf_of,
                         pkt_window, n_win, n_leaves, svc, fwd,
                         not_before=not_before)
    return (st, retx.sum(dtype=torch.int32),
            retx[:, -1].sum(dtype=torch.int32), n_win)


def retx_byte_count(n_retx: int, retx_last: int, wire_bytes: int,
                    mtu: int) -> int:
    """Exact retransmitted bytes from the two counts (Python ints —
    arbitrary precision, no wraparound): full-size packets re-emit ``mtu``
    bytes, the final partial packet re-emits its own size."""
    last = int(packet_sizes(wire_bytes, mtu)[-1])
    return (int(n_retx) - int(retx_last)) * mtu + int(retx_last) * last


def _at(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``table[i]`` for a 0-d device index, without reading it back."""
    return table.index_select(0, i.reshape(1).long())[0]


def _gia_compress(cfg: FediACConfig, spec, n: int, f_num_host, u, up, n_up,
                  counts, q_keys, dyn):
    """The GIA and phase-2 compress of a packet round: the scale f and the
    threshold a from the announced uploader count (the ``[N+1]`` tables),
    the round plan from the packet-derived counts, and the engine's
    compress of every row (rows are key-independent, so each equals the
    full-stack computation; the caller masks them).  Returns ``(f, a,
    plan, q_bufs, residuals)``."""
    stream, sharded = spec.name == "stream", spec.name == "sharded"
    topk = cfg.compact_mode != "block"
    m = torch.where(up, u.abs().amax(dim=1), 0.0).max()
    f = _at(f_num_host.to(u.device), n_up) / torch.clamp_min(m, 1e-12)
    a = _at(dyn["a_table"], n_up)
    plan = build_round_plan(counts, cfg, n, a=a,
                            with_dense_mask=(plan_wants_dense_mask(cfg)
                                             or ((stream or sharded)
                                                 and topk)),
                            with_slot_map=(stream or sharded) and topk)
    if stream:
        q_bufs, res = stream_compress_stack(u, cfg, f, q_keys, plan,
                                            chunk=spec.chunk or None)
    elif sharded:
        q_bufs, res = shard_compress_stack(u, cfg, f, q_keys, plan,
                                           devices=spec.devices or None)
    else:
        q_bufs, res = phase2_compress(cfg)(u, cfg, f, q_keys, plan)
    return f, a, plan, q_bufs, res


def _scatter_slots(cfg: FediACConfig, summed, plan, d: int):
    """De-compact closed (or weighted) slots to a float32 d-vector."""
    if cfg.compact_mode == "block":
        out = compaction.block_scatter(summed, plan.keep_dense, plan.pos, d,
                                       cfg.block_size, cfg.capacity_frac)
    else:
        out = scatter_sum(summed, plan.idx, plan.keep, cfg, d)
    return out.to(torch.float32)


def _scatter_delta(cfg: FediACConfig, summed, plan, d: int, kept, f,
                   n_commit):
    """De-compact the closed slots to a d-vector and divide by ``kept *
    f`` (tensor by tensor); exactly 0 when nobody committed."""
    delta = _scatter_slots(cfg, summed, plan, d) / (torch.clamp_min(kept, 1)
                                                     * f)
    return torch.where(n_commit > 0, delta, 0.0)


def _value_ops(uploaded, leaf_of: np.ndarray, n_leaves: int, c_live: int):
    """The register adds the value plane's walk would make (psim
    semantics priced from the uploader mask; the sums are associative, so
    the values never depend on the walk): each leaf adds its uploaders'
    rows, and the root adds the live leaves' partials."""
    dev = uploaded.device
    by_leaf = torch.zeros(n_leaves, dtype=torch.int32, device=dev).index_add_(
        0, torch.from_numpy(leaf_of.astype(np.int64)).to(dev),
        uploaded.to(torch.int32))
    ops = torch.clamp_min(by_leaf - 1, 0).sum(dtype=torch.int32) * c_live
    if n_leaves > 1:
        live_leaves = (by_leaf > 0).sum(dtype=torch.int32)
        ops = ops + torch.clamp_min(live_leaves - 1, 0) * c_live
    return ops


def _phase1(cfg: FediACConfig, net: NetConfig, n: int, u_stack, key,
            net_key, round_idx, rates, dyn):
    """A packet round up to the GIA: the round's static geometry, its keys,
    the participant and straggler masks, the lossy vote packets with the
    deadline, the vote counts, phase 1's close ``t1``, the uploader mask and
    the GIA broadcast's time.  Shared by the plain and the asynchronous
    cores, which differ only after it."""
    n_, d = u_stack.shape
    assert n_ == n, (n_, n)
    dev = u_stack.device
    n_chunks = d // cfg.vote_chunk
    tr = round_traffic(cfg, d)
    p1_pkts = n_packets(tr.phase1_bytes, net.mtu)
    gia_pkts = n_packets(-(-n_chunks // 8), net.mtu)
    cov = -(-n_chunks // p1_pkts)      # chunk coords per vote packet
    pkt_of_chunk = torch.as_tensor(
        np.minimum(np.arange(n_chunks) // cov, p1_pkts - 1), device=dev)

    rk = prng.fold_in(net_key, int(round_idx))
    k_part, k_strag, k_arr1, k_loss1, k_arr2, k_retx = prng.split(rk, 6)
    keys = prng.split(key, 2 * n)
    vote_keys, q_keys = keys[:n], keys[n:]

    # ---- round policies: masks, never index arrays.
    part = sample_participants(k_part, n, dyn["participation"])
    strag = sample_stragglers(k_strag, part, dyn["straggler_frac"])
    slow = torch.where(strag, torch.tensor(float(net.straggler_slowdown),
                                           dtype=torch.float32, device=dev),
                       1.0)
    train_s = dyn["local_train_s"] * slow
    rates = torch.as_tensor(rates, dtype=torch.float32, device=dev)
    eff_rates = rates / slow
    svc = dyn["svc"]

    # ---- phase 1: vote packets (lossy, no ARQ — the quorum absorbs).
    # Votes are computed for all N rows (each from its own key, so each
    # row equals the full-stack computation) and masked by delivery.
    arr1 = poisson_arrivals(k_arr1, eff_rates, p1_pkts, train_s)
    deliv = lose_packets(k_loss1, arr1.shape, dyn["loss"])
    deliv = deliv & part[:, None]
    if net.vote_deadline_s is not None:
        deliv = deliv & deadline_mask(arr1, net.vote_deadline_s)
    chunk_ok = deliv.index_select(1, pkt_of_chunk)
    votes = client_vote_stack(u_stack, cfg, vote_keys)
    # votes are 0/1, so their product with the delivery mask is an and
    counts = (votes.to(torch.bool) & chunk_ok).sum(dim=0, dtype=torch.int32)
    del votes
    st1 = _masked_drain(torch.where(deliv, arr1, _INF), svc)
    t1 = torch.where(st1.n_packets > 0, st1.completion_s,
                     torch.where(part, train_s, -_INF).max())
    if net.vote_deadline_s is not None:
        t1 = torch.clamp_min(t1, float(np.float32(net.vote_deadline_s)))

    # ---- quorum: who goes on to phase 2.
    voter = chunk_ok.any(dim=1)
    up = (part & voter) if net.drop_late_voters else part
    n_part = part.sum(dtype=torch.int32)
    return SimpleNamespace(
        d=d, tr=tr, k_arr2=k_arr2, k_retx=k_retx,
        q_keys=q_keys, part=part, strag=strag, rates=rates,
        eff_rates=eff_rates, svc=svc, counts=counts, t1=t1, up=up,
        n_up=up.sum(dtype=torch.int32), n_part=n_part,
        n_strag=strag.sum(dtype=torch.int32),
        votes_lost=n_part * p1_pkts - deliv.sum(dtype=torch.int32),
        delivered_chunks=chunk_ok.sum(dtype=torch.int32),
        t_gia=download_time(gia_pkts, rates))


def make_fediac_packet_core(cfg: FediACConfig, net: NetConfig,
                            n_clients: int):
    """Build the FediAC packet round.

    Static structure comes from ``cfg`` (compression geometry, engine) and
    the structural ``net`` fields (deadline presence, quorum policy, ARQ
    constants, register bank, hierarchy depth, MTU); ``net.loss`` /
    ``net.participation`` / ``net.straggler_frac`` are not read here —
    they come per call through ``dyn`` (:func:`packet_dyn`).  ``cfg.a`` /
    ``cfg.a_frac`` are likewise never read: the resolved per-``n_up``
    threshold table arrives in ``dyn["a_table"]``.

    The returned ``core(u_stack, key, net_key, round_idx, rates, dyn)``
    runs on ``u_stack``'s device and returns ``(delta, residuals, aux)``
    where ``aux`` carries the masks, vote counts and accounting scalars
    (0-d tensors) the transport prices the round from.  On the stream
    engine it compresses in ``EngineSpec.chunk`` coordinates (0: the
    engine's default), on the sharded engine over ``EngineSpec.devices``
    shards.
    """
    spec = engines.resolve(cfg)
    n = int(n_clients)
    leaf_of = leaf_assignment(n, net.n_leaves)
    f_num_host = torch.from_numpy(scale_num_table(cfg.bits, n))

    def core(u_stack, key, net_key, round_idx, rates, dyn):
        g = _phase1(cfg, net, n, u_stack, key, net_key, round_idx, rates,
                    dyn)
        up, n_up = g.up, g.n_up
        dev = u_stack.device

        # ---- GIA + phase-2 compress: the exact core.fediac machinery
        # against the packet-derived counts, run for every row and masked
        # by the uploader set.
        f, _, plan, q_bufs, res = _gia_compress(
            cfg, spec, n, f_num_host, u_stack, up, n_up, g.counts, g.q_keys,
            dyn)
        summed = torch.where(up[:, None], q_bufs, 0).sum(dim=0,
                                                          dtype=torch.int32)
        delta = _scatter_delta(cfg, summed, plan, g.d, n_up, f, n_up)
        residuals = torch.where(up[:, None], res, u_stack)
        del res

        # ---- phase 2: reliable int32 packets through the register bank.
        t_open = g.t1 + g.t_gia
        st2, n_retx, retx_last, n_win = reliable_upload(
            g.k_arr2, g.k_retx, g.eff_rates, t_open, q_bufs.shape[1],
            g.tr.phase2_bytes, leaf_of, g.svc, loss=dyn["loss"],
            rto_s=net.rto_s, max_retries=net.max_retries,
            memory_slots=net.memory_slots, n_leaves=net.n_leaves,
            mtu=net.mtu, not_before=t_open, row_mask=up)
        # with zero uploaders every phase-2 packet is masked and the
        # multi-leaf drain completes at -inf; clamp the phase-2 clock to
        # its start so the stats stay finite (wall falls back below)
        t2 = torch.maximum(st2.completion_s, t_open)
        wall2 = t2 + download_time(n_packets(g.tr.phase2_bytes, net.mtu),
                                   g.rates)
        wall = torch.where(n_up > 0, wall2, t_open)

        c_live = q_bufs.shape[1]
        value_ops = _value_ops(up, leaf_of, net.n_leaves, c_live)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        aux = {
            "participants": g.part, "stragglers": g.strag, "uploaders": up,
            "counts": g.counts,
            "n_part": g.n_part, "n_up": n_up,
            "n_strag": g.n_strag,
            "votes_lost": g.votes_lost,
            "retransmissions": n_retx, "retx_last": retx_last,
            "wall_clock_s": wall, "phase1_s": g.t1,
            "phase2_s": t2 - g.t1,
            "mean_wait_s": st2.mean_wait_s,
            "aggregation_ops": g.delivered_chunks
                               + torch.where(n_up > 0, value_ops, zero),
            "peak_live_slots": torch.where(
                n_up > 0, zero + min(net.memory_slots, c_live), zero),
            "passes": n_win,
        }
        return delta, residuals, aux

    return core


def packet_dyn(cfg: FediACConfig, net: NetConfig, n_clients: int,
               local_train_s: float, svc: float, device=None) -> dict:
    """The ``dyn`` dict for one scenario — the threshold table and float32
    scalars on ``device`` (the card unless told otherwise); build once,
    pass to every round."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return {"a_table": torch.as_tensor(threshold_table(cfg, n_clients),
                                       device=dev),
            "loss": f32(net.loss),
            "participation": f32(net.participation),
            "straggler_frac": f32(net.straggler_frac),
            "local_train_s": f32(local_train_s),
            "svc": f32(svc)}
