"""FediAC: the paper's two-phase consensus-compressed aggregation.

Two entry points, each bitwise equal to its namesake in the reference on
the same inputs and key:

* :func:`aggregate_stack` runs one round (Algo. 1) over a stacked
  ``[N, d]`` client-update matrix on the device the matrix lives on.  It
  is the FL simulator's aggregation path.  The N clients are a batch
  dimension throughout — the reference's per-client ``vmap`` — so the
  fused phase 2 (``EngineSpec(use_pallas=True)``) is one kernel launch for
  all clients (:mod:`repro_torch.kernels`).

* :func:`fediac_allreduce` is the production form: one client per rank of
  a ``torch.distributed`` group (:mod:`.collectives`), where the reference
  runs one client per device of a ``shard_map`` mesh axis.  Phase 1 sums
  uint8 votes, or all-gathers bit-packed votes and popcounts them (the
  ``vote_wire="packed"`` wire and its CUDA kernels); phase 2 sums an int32
  consensus-compacted buffer of ``C << d`` entries.

Ported: both vote modes (``topk``, sort-free ``threshold``), both compact
modes (``topk``, sort-free ``block``), any ``vote_chunk``, the fused
kernels on and off, both vote wires, and the three client-axis closes of
:mod:`.robust_agg` (``sum``, ``trim``, ``median``) in the stacked round.
The allreduce sums on the wire, so it takes ``robust_agg="sum"`` only, as
the reference's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.validate import (check_at_least, check_choice, check_interval,
                                  require)

from . import collectives, compaction, engines, prng, robust_agg, voting
from .quantize import dequantize, quantize, scale_factor
from .round_plan import RoundPlan, build_round_plan

__all__ = ["FediACConfig", "TrafficStats", "aggregate_stack",
           "aggregate_from_counts", "aggregate_round", "fediac_allreduce",
           "dense_allreduce", "client_compress", "client_vote_stack",
           "phase2_compress", "plan_wants_dense_mask", "scatter_sum",
           "round_traffic", "RoundPlan", "build_round_plan"]

#: FediACConfig.work_dtype names and their torch dtypes
WORK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class FediACConfig:
    """Hyper-parameters of FediAC (paper Sec. IV / V-A3), named as in the
    reference.  Only the fields the ported modes read are here; the
    engine's :class:`~.engines.EngineSpec` is the one switch for the fused
    CUDA kernels."""

    k_frac: float = 0.05          # vote budget k = k_frac * d   (paper: 5% d)
    a: int | None = None          # vote threshold; None -> ceil(a_frac * N)
    a_frac: float = 0.15          # paper Fig. 4: a in [5%N, 20%N] is robust
    bits: int = 12                # quantization bits b (Cor. 1 lower-bounds it)
    capacity_frac: float = 0.05   # compact buffer C = capacity_frac * d
    vote_chunk: int = 1           # g coords per vote bit (1 = paper-faithful)
    vote_dtype: str = "uint8"     # wire dtype of the phase-1 sum
    vote_wire: str = "count"      # allreduce phase 1: count (uint8 sum) |
                                  # packed (bit-packed all-gather + popcount)
    vote_mode: str = "topk"       # topk (paper-faithful) | threshold
    compact_mode: str = "topk"    # topk (global top-C)   | block
    block_size: int = 4096        # block compaction granule
    alpha: float = -1.0           # Def. 1 power-law exponent of threshold votes
    work_dtype: str = "float32"   # allreduce: dtype of the d-sized tensors
    granularity: str = "model"    # model: one vote over the whole raveled
                                  # update (paper-faithful); tensor: one
                                  # aggregation per parameter tensor (the
                                  # zoo's largest configs)
    engine: "str | engines.EngineSpec" = "monolithic"  # name or EngineSpec
    consensus_floor: int = 0      # dense-mask fallback floor (0 = off)
    robust_agg: str = "sum"       # sum | trim | median
    trim_frac: float = 0.0        # per-side trim fraction of robust_agg="trim"

    def __post_init__(self):
        check_interval("k_frac", self.k_frac, 0.0, 1.0, lo_open=True)
        check_interval("capacity_frac", self.capacity_frac, 0.0, 1.0,
                       lo_open=True)
        check_interval("a_frac", self.a_frac, 0.0, 1.0, lo_open=True)
        if self.a is not None:
            check_at_least("a", self.a, 1)
        check_at_least("bits", self.bits, 1)
        check_at_least("vote_chunk", self.vote_chunk, 1)
        check_at_least("block_size", self.block_size, 1)
        check_at_least("consensus_floor", self.consensus_floor, 0)
        require(math.isfinite(self.alpha), "alpha", "finite", self.alpha)
        check_choice("vote_mode", self.vote_mode, ("topk", "threshold"))
        check_choice("compact_mode", self.compact_mode, ("topk", "block"))
        check_choice("vote_wire", self.vote_wire, ("count", "packed"))
        check_choice("work_dtype", self.work_dtype, tuple(WORK_DTYPES))
        check_choice("granularity", self.granularity, ("model", "tensor"))
        check_choice("robust_agg", self.robust_agg, robust_agg.ROBUST_AGG_MODES)
        check_interval("trim_frac", self.trim_frac, 0.0, 0.5, hi_open=True)
        engines.get(self.engine)   # registered name or EngineSpec

    @property
    def kernels(self) -> bool:
        """Whether the round runs through the fused CUDA kernels (the
        engine spec's ``use_pallas``)."""
        return engines.resolve(self).use_pallas

    def k(self, d: int) -> int:
        return max(1, int(round(self.k_frac * d)))

    def threshold(self, n_clients: int) -> int:
        """Resolved vote threshold a for an N-client round."""
        if self.a is not None:
            return max(1, min(int(self.a), n_clients))
        return max(1, min(n_clients, math.ceil(self.a_frac * n_clients)))

    def capacity(self, d: int) -> int:
        c = max(1, int(round(self.capacity_frac * d)))
        return min(c, d)


@dataclass(frozen=True)
class TrafficStats:
    """Static per-round, per-client wire accounting (bytes)."""

    phase1_bytes: int     # vote array upload (per client)
    phase2_bytes: int     # compacted quantized values upload (per client)
    dense_bytes: int      # what dense fp32 FedAvg would have uploaded
    selected: int         # compact capacity C (upper bound on #selected)

    @property
    def total_bytes(self) -> int:
        return self.phase1_bytes + self.phase2_bytes

    @property
    def reduction(self) -> float:
        return 1.0 - self.total_bytes / max(self.dense_bytes, 1)


def round_traffic(cfg: FediACConfig, d: int) -> TrafficStats:
    n_chunks = d // cfg.vote_chunk
    vote_bytes = n_chunks * np.dtype(cfg.vote_dtype).itemsize
    c = cfg.capacity(n_chunks) * cfg.vote_chunk
    phase2 = c * max(1, math.ceil(cfg.bits / 8))
    return TrafficStats(phase1_bytes=int(vote_bytes), phase2_bytes=int(phase2),
                        dense_bytes=4 * d, selected=int(c))


# ---------------------------------------------------------------------------
# Client-local compression pieces (shared by both entry points)
# ---------------------------------------------------------------------------

def _vote_scores(u: torch.Tensor, cfg: FediACConfig) -> torch.Tensor:
    """What each client ranks in phase 1 (per chunk if vote_chunk > 1),
    along the last axis of one client's vector or of the client stack."""
    if cfg.vote_chunk > 1:
        return voting.chunk_scores(u, cfg.vote_chunk)
    return u


def _client_votes(u: torch.Tensor, cfg: FediACConfig,
                  key: torch.Tensor) -> torch.Tensor:
    """Phase-1 client side of the allreduce: one client's uint8 0/1 votes.
    The threshold is the staged one (:func:`.voting.vote_tau`), since the
    reference's allreduce runs under ``shard_map``."""
    scores = _vote_scores(u, cfg)
    k = cfg.k(scores.shape[-1])
    if cfg.vote_mode == "threshold":
        return voting.threshold_vote_mask(scores, k, scores.abs().max(),
                                          cfg.alpha, staged=True)
    return voting.vote_mask(scores, k, key)


def _vote_counts_stack(u_stack: torch.Tensor, cfg: FediACConfig,
                       keys: torch.Tensor) -> torch.Tensor:
    """Phase 1 over all clients at once: int32 vote counts.  In topk mode
    the counts accumulate without the [N, d] vote arrays."""
    if cfg.vote_mode == "threshold":
        return client_vote_stack(u_stack, cfg, keys).sum(dim=0,
                                                         dtype=torch.int32)
    scores = _vote_scores(u_stack, cfg)
    return voting.vote_counts_stack(scores, cfg.k(scores.shape[-1]), keys)


def client_vote_stack(u_stack: torch.Tensor, cfg: FediACConfig,
                      vote_keys: torch.Tensor) -> torch.Tensor:
    """Per-client phase-1 vote arrays, uint8[N, d/g]; their column sums are
    :func:`_vote_counts_stack`'s counts."""
    scores = _vote_scores(u_stack, cfg)
    k = cfg.k(scores.shape[-1])
    if cfg.vote_mode == "threshold":
        return voting.threshold_vote_mask(scores, k, scores.abs().amax(dim=-1),
                                          cfg.alpha)
    return voting.vote_mask_stack(scores, k, vote_keys)


def _block_compress_dense(u_stack: torch.Tensor, cfg: FediACConfig,
                          f: torch.Tensor, keys: torch.Tensor,
                          plan: RoundPlan):
    """Block-mode phase 2 without the wire form: ``(q int32[N, d],
    residuals)``, with ``q`` zero off the plan's kept coordinates.  Summing
    these and masking equals scattering back the summed compact buffers,
    so the stacked round skips the per-client compaction."""
    keep = plan.keep_dense
    uniforms = prng.uniform(keys, (u_stack.shape[-1],))
    q = quantize(torch.where(keep, u_stack, 0.0), f, uniforms)
    residuals = (u_stack - torch.where(keep, dequantize(q, f), 0.0))
    return q, residuals.to(u_stack.dtype)


def _block_compress(u_stack: torch.Tensor, cfg: FediACConfig, f: torch.Tensor,
                    keys: torch.Tensor, plan: RoundPlan):
    """Sort-free phase 2 (compact_mode="block"): the ``nb*cb`` compact
    buffers the allreduce sums, ``(q_bufs int32[N, nb*cb], residuals)``."""
    q, residuals = _block_compress_dense(u_stack, cfg, f, keys, plan)
    q_bufs = compaction.block_compact(q, plan.keep_dense, plan.pos,
                                      cfg.block_size, cfg.capacity_frac)
    return q_bufs, residuals


def client_compress(u_stack: torch.Tensor, cfg: FediACConfig, f: torch.Tensor,
                    keys: torch.Tensor, plan: RoundPlan):
    """Phase-2 client side against the shared round plan, for all clients.

    Returns ``(q_bufs int32[N, C·g], residuals)``: the compacted quantized
    uploads and the new error-feedback state, which is u with each client's
    own de-quantized upload subtracted at the consensus coordinates.  With
    the fused kernels on, the quantization is the ``stoch_quant`` kernel.
    """
    idx, keep = plan.idx, plan.keep
    n, d = u_stack.shape
    capacity = idx.shape[0]
    if cfg.vote_chunk > 1:
        g = cfg.vote_chunk
        u2 = u_stack.reshape(n, d // g, g)
        gathered = u2.index_select(1, idx).to(torch.float32) * keep[:, None]
        gathered = gathered.reshape(n, capacity * g)
    else:
        gathered = compaction.compact(u_stack, idx, keep).to(torch.float32)
    uniforms = prng.uniform(keys, (gathered.shape[-1],))
    if cfg.kernels:
        q_bufs = kops.quantize_flat(gathered, uniforms, f)
    else:
        q_bufs = quantize(gathered, f, uniforms)
    up = dequantize(q_bufs, f).to(u_stack.dtype)
    # the reference's `u.at[idx].add(-vals)`: indices are unique, so an
    # indexed assignment of `u + -vals` is the same single rounding
    rows = idx.long()
    if cfg.vote_chunk > 1:
        vals = up.reshape(n, capacity, g) * keep[:, None].to(u_stack.dtype)
        residuals = u2.clone()
        residuals[:, rows] = u2[:, rows] + -vals
        residuals = residuals.reshape(n, d)
    else:
        vals = (up.to(torch.float32) * keep).to(u_stack.dtype)
        residuals = u_stack.clone()
        residuals[:, rows] = u_stack[:, rows] + -vals
    return q_bufs, residuals


def _client_compress_fused(u_stack: torch.Tensor, cfg: FediACConfig,
                           f: torch.Tensor, keys: torch.Tensor,
                           plan: RoundPlan):
    """Fused phase 2: one ``gather_quant`` launch over the whole stack
    computes the masked stochastic quantization and the residual (in
    float32, as the reference's kernel casts u); the C-sized consensus
    gather then reads the already-quantized buffer.

    Draws d uniforms per client (one per coordinate), as the reference's
    fused path does.
    """
    uniforms = prng.uniform(keys, (u_stack.shape[-1],))
    q_dense, residuals = kops.gather_quant_flat(u_stack.to(torch.float32),
                                                uniforms, plan.sel, f)
    return q_dense.index_select(1, plan.idx), residuals.to(u_stack.dtype)


def phase2_compress(cfg: FediACConfig):
    """Pick the phase-2 implementation for this config."""
    if cfg.compact_mode == "block":
        return _block_compress
    if plan_wants_dense_mask(cfg):
        return _client_compress_fused
    return client_compress


def plan_wants_dense_mask(cfg: FediACConfig) -> bool:
    return cfg.kernels and cfg.vote_chunk == 1 and cfg.compact_mode != "block"


def scatter_sum(summed_q: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                cfg: FediACConfig, d: int) -> torch.Tensor:
    """De-compact the aggregated C-sized buffer back to a d-vector."""
    if cfg.vote_chunk > 1:
        g = cfg.vote_chunk
        out = torch.zeros((d // g, g), dtype=summed_q.dtype,
                          device=summed_q.device)
        out[idx.long()] = (summed_q.reshape(idx.shape[0], g)
                           * keep[:, None].to(summed_q.dtype))
        return out.reshape(-1)
    return compaction.scatter_compact(summed_q, idx, keep, d)


# ---------------------------------------------------------------------------
# The stacked round (Algo. 1, the FL-simulator path)
# ---------------------------------------------------------------------------

def aggregate_stack(u_stack: torch.Tensor, cfg: FediACConfig, key: torch.Tensor,
                    *, a=None):
    """Run one FediAC round over N stacked client updates, on their device.

    u_stack: float32[N, d] — U_t^i = local update + carried residual.
    key: the round's threefry key (int64[2], :mod:`.prng`), on that device.
    Returns (delta[d] — the *mean* update to apply to the global model,
             residuals[N, d], counts[d//g], TrafficStats).
    ``a`` optionally overrides the vote threshold.
    """
    n = u_stack.shape[0]
    # Phase 1: every client votes; the PS sums 0/1 arrays.
    counts = _vote_counts_stack(u_stack, cfg, prng.split(key, 2 * n)[:n])
    delta, residuals = aggregate_from_counts(u_stack, cfg, key, counts, a=a)
    return delta, residuals, counts, round_traffic(cfg, u_stack.shape[1])


def aggregate_from_counts(u_stack: torch.Tensor, cfg: FediACConfig,
                          key: torch.Tensor, counts: torch.Tensor, *, a=None,
                          close=None):
    """The rest of :func:`aggregate_stack` after phase 1: scale factor,
    consensus plan, phase 2 and the aggregate, from given vote counts.
    ``close(q) -> (summed, kept)`` closes the client axis of the quantized
    stack (default :func:`.robust_agg.client_sum`).  Returns ``(delta,
    residuals)``."""
    close = close or (lambda q: robust_agg.client_sum(q, cfg))
    n, d = u_stack.shape
    q_keys = prng.split(key, 2 * n)[n:]
    # Scale factor from the global max magnitude (SwitchML-style).  The
    # numerator is a float32 tensor, not a Python float: torch evaluates
    # `float / tensor` as `reciprocal(tensor) * float`, which rounds
    # differently from the reference's division.
    m = u_stack.abs().max()
    sf = torch.tensor(scale_factor(cfg.bits, n, 1.0), dtype=torch.float32,
                      device=u_stack.device)
    f = sf / torch.clamp_min(m, 1e-12)
    # Phase 2: the consensus plan is built once from the shared counts and
    # passed into every client's compress.
    plan = build_round_plan(counts, cfg, n, a=a,
                            with_dense_mask=plan_wants_dense_mask(cfg))
    if cfg.compact_mode == "block":
        # the summed compact buffers scattered back equal the masked sum of
        # the dense quantized stacks: no per-client compaction
        q_dense, residuals = _block_compress_dense(u_stack, cfg, f, q_keys,
                                                   plan)
        summed, kept = close(q_dense)
        delta = (torch.where(plan.keep_dense, summed, 0).to(torch.float32)
                 / (kept * f))
        return delta, residuals
    q_bufs, residuals = phase2_compress(cfg)(u_stack, cfg, f, q_keys, plan)
    # the PS's pipelined integer addition, or its trim / median close
    summed, kept = close(q_bufs)
    delta = (scatter_sum(summed, plan.idx, plan.keep, cfg, d).to(torch.float32)
             / (kept * f))
    return delta, residuals


def aggregate_round(u_stack: torch.Tensor, cfg: FediACConfig, key: torch.Tensor,
                    *, a=None, probe=None):
    """Run one stacked round on the engine ``cfg.engine`` selects.

    ``probe`` (a :mod:`repro_torch.obs` probe) puts a host span named
    ``engine-<name>`` around the engine call; the round is the same with
    or without it."""
    if probe is not None and getattr(probe, "enabled", False):
        with probe.span(f"engine-{engines.resolve(cfg).name}"):
            return engines.run(u_stack, cfg, key, a=a)
    return engines.run(u_stack, cfg, key, a=a)


# ---------------------------------------------------------------------------
# Production: one client per rank of a torch.distributed group
# ---------------------------------------------------------------------------

def fediac_allreduce(u: torch.Tensor, residual: torch.Tensor, key: torch.Tensor,
                     cfg: FediACConfig, group=None, *,
                     return_counts: bool = False):
    """Compressed mean of ``u + residual`` over the clients of ``group``.

    Every rank of the ``torch.distributed`` group (the default group when
    ``None``) is one client and calls this with its own flat update ``u``
    and error-feedback ``residual`` (``[d]``, on its device) and the same
    round ``key``.  Returns ``(mean_update, new_residual)``; every rank
    gets the same mean.  ``return_counts`` appends the round's int32
    phase-1 vote counts (the same on every rank), for checks.

    Wire per client: d/g uint8 votes (``vote_wire="count"``) or the packed
    words (``"packed"``: N·d/(8g) bytes gathered), then C·g int32 values.
    """
    require(cfg.robust_agg == "sum", "robust_agg",
            '"sum" for the allreduce wire path (a sum cannot compute '
            "order statistics in-network; robust modes keep the stacked "
            "engine)", cfg.robust_agg)
    d0 = u.shape[-1]
    pad = (-d0) % cfg.vote_chunk
    wdt = WORK_DTYPES[cfg.work_dtype]
    u = u.to(wdt) + residual.to(wdt)
    if pad:
        u = torch.cat([u, u.new_zeros(pad)])
    d = u.shape[-1]
    n = collectives.size(group)
    # the client's key: the round key folded with its index on the axis
    kv, kq = prng.split(prng.fold_in(key, collectives.rank(group)))

    # ---- Phase 1: vote, then the "switch" sums 0/1 arrays.
    if cfg.vote_wire == "packed":
        # all-gather the N clients' bit-packed words, then popcount them
        n_chunks = d // cfg.vote_chunk
        if cfg.kernels and cfg.vote_mode == "threshold":
            # fused wire build: |score| >= tau straight into packed words
            scores = _vote_scores(u, cfg).abs()
            k = max(1, min(cfg.k(n_chunks), n_chunks))
            tau = voting.vote_tau(scores.max(), k, cfg.alpha, staged=True)
            packed = kops.pack_votes_threshold(scores, tau)
        else:
            packed = kops.pack_votes(_client_votes(u, cfg, kv))
        counts = kops.count_votes(collectives.all_gather(packed, group),
                                  n_chunks)
    else:
        votes = _client_votes(u, cfg, kv).to(getattr(torch, cfg.vote_dtype))
        counts = collectives.psum_(votes, group).to(torch.int32)

    # ---- Scale factor from the global max magnitude (a scalar max), in
    # the working dtype, as the reference's weakly typed division gives it.
    m = collectives.pmax_(u.abs().max(), group)
    sf = torch.tensor(scale_factor(cfg.bits, n, 1.0), dtype=torch.float32,
                      device=u.device).to(wdt)
    f = sf / torch.clamp_min(m, 1e-12)

    # ---- Phase 2: every client builds the same plan from the same counts
    # (the switch broadcasting the GIA); compress, then sum C entries.
    plan = build_round_plan(counts, cfg, n,
                            with_dense_mask=plan_wants_dense_mask(cfg))
    q_buf, new_residual = phase2_compress(cfg)(u[None], cfg, f, kq[None], plan)
    summed = collectives.psum_(q_buf[0], group)
    nf = n * f
    if cfg.compact_mode == "block":
        mean = compaction.block_scatter(summed, plan.keep_dense, plan.pos, d,
                                        cfg.block_size, cfg.capacity_frac)
        mean = mean.to(torch.float32) / nf
    else:
        # de-quantize the compact buffer first: the d-sized scatter result
        # then lives in the working dtype, not int32
        mean_buf = (summed.to(torch.float32) / nf).to(wdt)
        mean = scatter_sum(mean_buf, plan.idx, plan.keep, cfg, d)
    if return_counts:
        return mean[:d0], new_residual[0, :d0], counts
    return mean[:d0], new_residual[0, :d0]


def dense_allreduce(u: torch.Tensor, residual: torch.Tensor, key: torch.Tensor,
                    cfg: FediACConfig | None = None, group=None):
    """Uncompressed FedAvg mean, the dense baseline with the same
    signature: ``(mean of u + residual over the clients, zeros)``."""
    total = collectives.psum_in_order((u + residual).to(torch.float32), group)
    n = torch.tensor(collectives.size(group), dtype=torch.float32,
                     device=total.device)
    return total / n, torch.zeros_like(residual)
