"""The coordinate-sharded round engine: one FediAC round over shards of d.

:func:`repro_torch.core.fediac.aggregate_stack` and
:func:`repro_torch.core.stream_engine.aggregate_stream` run the round on
one device.  This engine splits the coordinate axis into ``devices``
contiguous shards, each on its own device, so that what one device holds
falls to about 1/devices of the round.  One controller drives the shards,
as the reference's ``shard_map`` body runs on every device of its mesh.
Shard ``i`` lives on CUDA device ``i mod device_count`` (on one card every
shard is on it); on the CPU every shard is on the CPU.  The shards meet
only through the integer sums, maxima and gathers of small vectors in the
"Shard collectives" section below, done in shard order on shard 0's
device; no float is ever summed over shards.  The round is bitwise
:func:`~repro_torch.core.fediac.aggregate_stack` in every vote and compact
mode, for four reasons:

1. **Phase-1 votes are shard-local.**  Threshold votes need each client's
   global max |u|: one max over shards.  Gumbel top-k votes need each
   client's global k-th score: a shard's scores are its columns of the
   whole draw (:func:`.voting.vote_scores`), mapped to
   order-preserving int32 keys, and the k-th largest key is found by a
   32-pass MSB-first bisection whose only communication is a count summed
   over shards per pass.  Ties at the boundary go by global index (each
   shard's tie count, summed over the shards before it), which is the
   stable ``lax.top_k`` order of :func:`.selection.topk_counts_stack`.
2. **The consensus threshold comes from count histograms.**  Counts are
   ints in ``[0, N]``, so the summed ``[N+1]`` histogram gives the C-th
   largest count c* and the tie budget, with no d-sized sort.
3. **Compact-buffer slots come from per-shard class counts.**  A selected
   coordinate's slot is ``#(count > c)`` (a suffix of the global
   histogram) plus its rank among ``count == c`` by global index (the
   class counts of the shards before it plus a local stable sort).  Each
   shard reads its coordinates' uniforms in place with
   :func:`.streams.uniform_at`; the C-sized draw is never made.
4. **Phase 2 is shard-local**, in the stream engine's cast chains, in
   column chunks of :data:`_PHASE2_CHUNK`.

A shard holds only its true coordinates: the reference pads d to a
multiple of devices (× ``block_size`` in block mode) with coordinates that
carry count 0, sort after every true one and are masked everywhere, so
leaving them out changes no bit.  Every draw is in jax's partitionable
layout, as :mod:`.prng`'s.

``vote_chunk > 1`` and the fused kernels are not sharded (the reference
refuses them too); those modes keep the monolithic or stream engine.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.validate import require

from . import compaction, prng, robust_agg, voting
from .fediac import round_traffic
from .quantize import dequantize, quantize, scale_factor
from .round_plan import RoundPlan
from .streams import uniform_at, uniform_block

__all__ = ["aggregate_shard", "shard_compress_stack", "shard_geometry"]

#: column chunk of a shard's threshold votes and phase 2: above this width
#: a shard's ``[N, chunk]`` draws and casts go chunk by chunk (its top-k
#: scores are drawn in pieces of ``voting.SCORE_PIECE`` elements)
_PHASE2_CHUNK = 1 << 18


def _check_shardable(cfg) -> None:
    if cfg.vote_chunk != 1:
        raise NotImplementedError(
            "the sharded engine requires vote_chunk == 1 "
            "(chunked vote bits keep the monolithic engine)")
    if cfg.kernels:
        raise NotImplementedError(
            "the sharded engine does not route through the fused CUDA "
            "kernels; use the monolithic or stream engine for use_pallas")


def shard_geometry(d: int, n_dev: int, cfg) -> tuple[int, int]:
    """(shard size S, padded length D = S * n_dev) for a d-vector.

    In block-compact mode S is rounded up to a ``block_size`` multiple so
    that blocks never straddle shards (the stream engine keeps the same
    rule for chunks).
    """
    s = -(-d // n_dev)
    if cfg.compact_mode == "block":
        bs = int(cfg.block_size)
        s = -(-s // bs) * bs
    return s, s * n_dev


@dataclasses.dataclass
class _Shard:
    """One coordinate shard: global columns ``[start, start + width)``."""
    start: int
    width: int
    device: torch.device
    u: torch.Tensor          # [N, width], the shard's columns on its device


def _n_devices(devices, device: torch.device) -> int:
    if devices is None or devices == 0:
        return torch.cuda.device_count() if device.type == "cuda" else 1
    require(isinstance(devices, int) and not isinstance(devices, bool)
            and devices >= 1, "devices", "a positive int", devices)
    return devices


def _shards(u_stack: torch.Tensor, n_dev: int, s: int) -> list[_Shard]:
    """The non-empty shards of ``u_stack``, round-robin over the visible
    CUDA devices (all on the CPU for a CPU stack)."""
    d = u_stack.shape[1]
    n_cuda = torch.cuda.device_count() if u_stack.device.type == "cuda" else 0
    out = []
    for i in range(n_dev):
        start = i * s
        width = min(s, d - start)
        if width <= 0:
            break
        dev = (torch.device("cuda", i % n_cuda) if n_cuda
               else u_stack.device)
        out.append(_Shard(start, width, dev,
                          u_stack[:, start:start + width].to(dev)))
    return out


# ---------------------------------------------------------------------------
# Shard collectives: small integer vectors and scalars, in shard order on
# shard 0's device (the reference's psum / pmax / all_gather over the mesh)
# ---------------------------------------------------------------------------

def _sum_over(shards, parts) -> torch.Tensor:
    """The sum of one integer tensor per shard, on shard 0's device.
    ``parts`` may be a generator, so that each part is freed once added."""
    parts = iter(parts)
    total = next(parts).to(shards[0].device)
    for p in parts:
        total = total + p.to(total.device)
    return total


def _max_over(shards, parts: list) -> torch.Tensor:
    """The elementwise max of one tensor per shard, on shard 0's device."""
    dev = shards[0].device
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = torch.maximum(total, p.to(dev))
    return total


def _offsets(shards, parts: list) -> list:
    """Exclusive prefix sums over the shards: shard i gets the sum of the
    parts of shards 0 .. i-1, on its own device."""
    acc = torch.zeros_like(parts[0])
    out = []
    for sh, p in zip(shards, parts):
        out.append(acc.to(sh.device))
        acc = acc + p.to(acc.device)
    return out


def _bcast(shards, t: torch.Tensor) -> list:
    """``t`` on every shard's device."""
    return [t.to(sh.device) for sh in shards]


# ---------------------------------------------------------------------------
# Phase 1: vote counts and the global max |u|
# ---------------------------------------------------------------------------

def _f32_sort_keys_(x: torch.Tensor) -> torch.Tensor:
    """int32 keys with the order of float32 ``x`` (no NaN), written over
    ``x`` and returned as its int32 view: the reference's uint32 keys (flip
    every bit of a negative, set the sign bit of the rest) minus 2**31,
    which is the bits of ``x`` with the 31 low bits of negatives flipped.
    -inf is the least key of any float, and FediAC scores hold no -0.0, so
    equal keys are equal scores."""
    b = x.view(torch.int32)
    flip = b >> 31              # arithmetic: -1 for negatives, else 0
    flip &= 0x7FFFFFFF
    b ^= flip
    return b


def _kth_largest_key(shards, keys: list, k: int) -> torch.Tensor:
    """Each row's k-th largest key over all shards, int32 ``[N]``: the
    MSB-first bisection of the unsigned key ``t + 2**31``, one count summed
    over the shards per bit."""
    rows = keys[0].shape[0]
    acc = torch.zeros((rows,), dtype=torch.int64, device=shards[0].device)
    for bit in range(31, -1, -1):
        cand = acc | (1 << bit)
        thr = _bcast(shards, (cand - (1 << 31)).to(torch.int32).unsqueeze(1))
        ge = _sum_over(shards, [(kk >= t).sum(dim=1, dtype=torch.int32)
                                for kk, t in zip(keys, thr)])
        acc = torch.where(ge >= k, cand, acc)
    return (acc - (1 << 31)).to(torch.int32)


def _phase1_threshold(shards, cfg, k: int):
    """Threshold votes: each client's max |u| over the shards, its tau, then
    ``|u| >= tau`` counted chunk by chunk.  Returns (counts per shard,
    the global max |u|)."""
    m_vec = _max_over(shards, [sh.u.abs().amax(dim=1) for sh in shards])
    taus = _bcast(shards, voting.vote_tau(m_vec, k, cfg.alpha).unsqueeze(1))
    counts = []
    for sh, tau in zip(shards, taus):
        c = torch.empty((sh.width,), dtype=torch.int32, device=sh.device)
        for st in range(0, sh.width, _PHASE2_CHUNK):
            u_c = sh.u[:, st:st + _PHASE2_CHUNK]
            votes = u_c.abs().to(torch.float32) >= tau
            c[st:st + _PHASE2_CHUNK] = votes.sum(dim=0, dtype=torch.int32)
        counts.append(c)
    return counts, m_vec.max()


def _phase1_topk(shards, vote_keys: torch.Tensor, k: int, d: int):
    """Gumbel top-k votes: each shard's keys of its columns of the score
    draw, the global k-th key per client by bisection, then the index-
    ordered tie fill.  Returns (counts per shard, the global max |u|)."""
    vks = _bcast(shards, vote_keys)
    keys = [_f32_sort_keys_(voting.vote_scores(
        sh.u, vk, sh.start, d, piece=voting.SCORE_PIECE))
        for sh, vk in zip(shards, vks)]
    t = _bcast(shards, _kth_largest_key(shards, keys, k).unsqueeze(1))
    n_gt = _sum_over(shards, [(kk > tt).sum(dim=1, dtype=torch.int32)
                              for kk, tt in zip(keys, t)])
    budgets = _bcast(shards, (k - n_gt).unsqueeze(1))
    tie_off = _offsets(shards, [(kk == tt).sum(dim=1, dtype=torch.int32)
                                for kk, tt in zip(keys, t)])
    counts = []
    for i, (kk, tt) in enumerate(zip(keys, t)):
        eq = kk == tt
        eq_i = eq.to(torch.int32)
        # each tie's global rank: the ties of the shards before, plus the
        # shard's ties before it in its row
        rank = torch.cumsum(eq_i, dim=1, dtype=torch.int32)
        rank -= eq_i
        del eq_i
        rank += tie_off[i].unsqueeze(1)
        take = eq & (rank < budgets[i])
        del eq, rank
        counts.append(((kk > tt) | take).sum(dim=0, dtype=torch.int32))
        keys[i] = None          # this shard's keys are done with
        del take
    m = _max_over(shards, [sh.u.abs().max() for sh in shards])
    return counts, m


# ---------------------------------------------------------------------------
# The consensus plan from count histograms
# ---------------------------------------------------------------------------

def _suffix_counts(hist: torch.Tensor) -> torch.Tensor:
    """[n+2] suffix sums G of an [n+1] count histogram: G[v] = #counts >= v
    (G[n+1] = 0)."""
    g = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0, dtype=torch.int32),
                   (0,))
    return torch.cat([g, g.new_zeros(1)])


def _histogram(counts: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(counts, minlength=n + 1).to(torch.int32)


def _floored_threshold(cfg, a_arr: torch.Tensor, garr, n: int):
    """``round_plan.consensus_floor_threshold`` from the histogram: the
    live-coordinate count is the suffix sum at ``a``."""
    if cfg.consensus_floor <= 0:
        return a_arr
    live = garr[torch.clamp(a_arr, 0, n + 1).long()]
    return torch.where(live < cfg.consensus_floor, torch.ones_like(a_arr),
                       a_arr)


def _consensus_shard(counts: torch.Tensor, hist: torch.Tensor,
                     cls_off: torch.Tensor, garr: torch.Tensor,
                     c_star: torch.Tensor, n_gt: torch.Tensor, capacity: int):
    """One shard's consensus selection: (sel bool[S], slot int32[S]).

    ``sel`` is the stable top-C membership (count descending, index
    ascending: ``selection.consensus_topk``'s rule); ``slot`` is a
    selected coordinate's position in that order, its compact-buffer slot.
    """
    s = counts.shape[0]
    # rank within the shard's count class: one stable sort (count
    # descending, index ascending), inverted, minus the shard's #(count > c)
    order = torch.sort(counts, descending=True, stable=True).indices
    rank_of = torch.empty((s,), dtype=torch.int32, device=counts.device)
    rank_of[order] = torch.arange(s, dtype=torch.int32, device=counts.device)
    del order
    above = counts + 1
    lrank = rank_of - _suffix_counts(hist).index_select(0, above)
    grank = cls_off.index_select(0, counts) + lrank
    sel = (counts > c_star) | ((counts == c_star) & (grank < capacity - n_gt))
    return sel, garr.index_select(0, above) + grank


# ---------------------------------------------------------------------------
# Phase 2: per-coordinate compress of one column chunk of a shard
# ---------------------------------------------------------------------------

def _topk_coord_phase2(u_c, f, q_keys, keep_f, slot, capacity: int):
    """Top-k compact phase 2 on a chunk, coordinate by coordinate: the
    stream engine's cast chain (that of ``client_compress``), with the
    slot's uniform read in place.  ``q`` is zero at every coordinate not
    kept, so the others (clipped dummy slots) contribute exact zeros."""
    dt = u_c.dtype
    uni = uniform_at(q_keys, torch.clamp(slot, 0, capacity - 1), capacity)
    gathered = (u_c.to(torch.float32) * keep_f).to(dt).to(torch.float32)
    q = quantize(gathered, f, uni)
    vals = (dequantize(q, f).to(dt).to(torch.float32) * keep_f).to(dt)
    return q, u_c - vals


def _block_coord_phase2(u_c, f, q_keys, keep_b, start: int, d: int):
    """Block compact phase 2 on the chunk of global columns ``[start,
    start + width)``: the stream engine's ``_block_chunk`` against the
    chunk's slice of each client's d-sized uniform stream."""
    uni = uniform_block(q_keys, start, u_c.shape[1], d)
    q = quantize(torch.where(keep_b, u_c, 0.0), f, uni)
    return q, (u_c - torch.where(keep_b, dequantize(q, f), 0.0)).to(u_c.dtype)


def _chunks(width: int, cs: int):
    for st in range(0, width, cs):
        yield st, min(cs, width - st)


def _block_chunk(cfg) -> int:
    """Block mode's chunk: :data:`_PHASE2_CHUNK` rounded up to whole
    blocks, so that a chunk's blocks are whole."""
    bs = int(cfg.block_size)
    return -(-_PHASE2_CHUNK // bs) * bs


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def aggregate_shard(u_stack: torch.Tensor, cfg, key: torch.Tensor, *, a=None,
                    devices: int | None = None):
    """One FediAC round over ``devices`` coordinate shards, bitwise equal
    to :func:`repro_torch.core.fediac.aggregate_stack` (same arguments,
    same ``(delta, residuals, counts, TrafficStats)``, on ``u_stack``'s
    device) in every vote and compact mode and client-axis close.

    ``devices`` is the number of shards (``None`` or 0: one per visible
    CUDA device for a stack on the card, 1 on the CPU).  ``a`` optionally
    overrides the vote threshold (an int or an int32 0-dim tensor).
    """
    n, d = u_stack.shape
    _check_shardable(cfg)
    n_dev = _n_devices(devices, u_stack.device)
    shards = _shards(u_stack, n_dev, shard_geometry(d, n_dev, cfg)[0])
    dev0 = shards[0].device
    keys = prng.split(key, 2 * n)
    vote_keys, q_keys = keys[:n], keys[n:]
    k = min(cfg.k(d), d)
    capacity = cfg.capacity(d)
    a_arr = torch.as_tensor(cfg.threshold(n) if a is None else a,
                            dtype=torch.int32).to(dev0)

    if cfg.vote_mode == "threshold":
        counts, m = _phase1_threshold(shards, cfg, k)
    else:
        counts, m = _phase1_topk(shards, vote_keys, k, d)
    sf = torch.tensor(scale_factor(cfg.bits, n, 1.0), dtype=torch.float32,
                      device=dev0)
    fs = _bcast(shards, sf / torch.clamp_min(m, 1e-12))
    qks = _bcast(shards, q_keys)

    block = cfg.compact_mode == "block"
    hists = garr = None
    if not block or cfg.consensus_floor > 0:
        # the global [N+1] histogram of the vote counts, as suffix sums
        hists = [_histogram(c, n) for c in counts]
        garr = _suffix_counts(_sum_over(shards, hists))
    a_effs = _bcast(shards, _floored_threshold(cfg, a_arr, garr, n))
    if not block:
        vs = torch.arange(n + 1, dtype=torch.int32, device=dev0)
        c_star = torch.where(garr[:-1] >= capacity, vs, 0).max()
        n_gt = garr[c_star.long() + 1]
        cls_offs = _offsets(shards, hists)
        garrs, c_stars, n_gts = (_bcast(shards, x)
                                 for x in (garr, c_star, n_gt))

    out_dev = u_stack.device
    delta = torch.empty((d,), dtype=torch.float32, device=out_dev)
    residuals = torch.empty((n, d), dtype=u_stack.dtype, device=out_dev)
    for i, sh in enumerate(shards):
        c, f, qk = counts[i], fs[i], qks[i]
        if block:
            keep, _ = compaction.block_select(c, a_effs[i], cfg.block_size,
                                              cfg.capacity_frac)
            cs = _block_chunk(cfg)
        else:
            sel, slot = _consensus_shard(c, hists[i], cls_offs[i], garrs[i],
                                         c_stars[i], n_gts[i], capacity)
            keep = (sel & (c >= a_effs[i])).to(torch.float32)
            del sel
            cs = _PHASE2_CHUNK
        for st, w in _chunks(sh.width, cs):
            u_c, kc = sh.u[:, st:st + w], keep[st:st + w]
            if block:
                q, r = _block_coord_phase2(u_c, f, qk, kc, sh.start + st, d)
                qagg, kept = robust_agg.client_sum(q, cfg)
                dc = torch.where(kc, qagg, 0).to(torch.float32) / (kept * f)
            else:
                q, r = _topk_coord_phase2(u_c, f, qk, kc, slot[st:st + w],
                                          capacity)
                # scatter_compact's cast chain, coordinate by coordinate
                qagg, kept = robust_agg.client_sum(q, cfg)
                dc = ((qagg.to(torch.float32) * kc).to(torch.int32)
                      .to(torch.float32) / (kept * f))
            g = sh.start + st
            delta[g:g + w] = dc
            residuals[:, g:g + w] = r
    counts = torch.cat([c.to(out_dev) for c in counts])
    return delta, residuals, counts, round_traffic(cfg, d)


def shard_compress_stack(u_stack: torch.Tensor, cfg, f: torch.Tensor,
                         q_keys: torch.Tensor, plan: RoundPlan, *,
                         devices: int | None = None):
    """Coordinate-sharded phase 2 returning every client's compact buffer:
    ``(q_bufs int32[N, C], residuals [N, d])``, bitwise equal to the
    stacked phase-2 compress (:func:`repro_torch.core.fediac
    .phase2_compress`) against the same plan.  For the packet dataplane,
    as :func:`.stream_engine.stream_compress_stack` is.

    Top-k mode: each shard scatter-adds its coordinates' values into the
    slots it owns, and the partial buffers are summed over the shards
    (slots are disjoint, the adds exact).  Block mode: blocks never
    straddle shards, so the buffers are the shards' own, side by side.
    In top-k mode ``plan`` must carry the dense mask and the slot map
    (``build_round_plan(..., with_dense_mask=True, with_slot_map=True)``).
    """
    n, d = u_stack.shape
    _check_shardable(cfg)
    n_dev = _n_devices(devices, u_stack.device)
    shards = _shards(u_stack, n_dev, shard_geometry(d, n_dev, cfg)[0])
    fs, qks = _bcast(shards, f), _bcast(shards, q_keys)
    out_dev = u_stack.device
    residuals = torch.empty((n, d), dtype=u_stack.dtype, device=out_dev)
    if cfg.compact_mode == "block":
        parts = []
        for sh, f_i, qk in zip(shards, fs, qks):
            keep = plan.keep_dense[sh.start:sh.start + sh.width].to(sh.device)
            pos = plan.pos[sh.start:sh.start + sh.width].to(sh.device)
            for st, w in _chunks(sh.width, _block_chunk(cfg)):
                kc = keep[st:st + w]
                q, r = _block_coord_phase2(sh.u[:, st:st + w], f_i, qk, kc,
                                           sh.start + st, d)
                residuals[:, sh.start + st:sh.start + st + w] = r
                parts.append(compaction.block_compact(
                    q, kc, pos[st:st + w], cfg.block_size,
                    cfg.capacity_frac).to(out_dev))
        return torch.cat(parts, dim=1), residuals
    capacity = plan.capacity

    def shard_bufs():
        for sh, f_i, qk in zip(shards, fs, qks):
            sel = plan.sel[sh.start:sh.start + sh.width].to(sh.device)
            slot = plan.slot[sh.start:sh.start + sh.width].to(sh.device)
            buf = torch.zeros((n, capacity), dtype=torch.int32,
                              device=sh.device)
            for st, w in _chunks(sh.width, _PHASE2_CHUNK):
                q, r = _topk_coord_phase2(sh.u[:, st:st + w], f_i, qk,
                                          sel[st:st + w].to(torch.float32),
                                          slot[st:st + w], capacity)
                residuals[:, sh.start + st:sh.start + st + w] = r
                # q is 0 off the kept coordinates, so the dummy slot-0
                # adds of the others add nothing
                buf.index_add_(1, slot[st:st + w], q)
            yield buf

    return _sum_over(shards, shard_bufs()).to(out_dev), residuals
