"""FediAC: the paper's two-phase consensus-compressed aggregation.

:func:`aggregate_stack` runs one round (Algo. 1) over a stacked ``[N, d]``
client-update matrix on the device the matrix lives on.  It is the FL
simulator's aggregation path and is bitwise equal to the reference's
``aggregate_stack`` on the same inputs and key.

The N clients are a batch dimension throughout — the reference's
per-client ``vmap`` — so each step of the round is one pass over the
stack, and the fused phase 2 (``EngineSpec(use_pallas=True)``) is one
kernel launch for all clients (:mod:`repro_torch.kernels`).

Ported: ``vote_mode="topk"``, ``compact_mode="topk"``, any ``vote_chunk``,
the fused kernels on and off, ``robust_agg="sum"``.  The threshold and
block modes, the robust closes and the in-network allreduce raise
``NotImplementedError`` naming their ROADMAP item; their knobs come with
them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.validate import check_at_least, check_choice, check_interval

from . import compaction, engines, prng, robust_agg, voting
from .quantize import dequantize, quantize, scale_factor
from .round_plan import RoundPlan, build_round_plan

__all__ = ["FediACConfig", "TrafficStats", "aggregate_stack",
           "aggregate_from_counts", "aggregate_round", "fediac_allreduce", "client_compress",
           "phase2_compress", "plan_wants_dense_mask", "scatter_sum",
           "round_traffic", "RoundPlan", "build_round_plan"]


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
    vote_mode: str = "topk"       # topk (paper-faithful) | threshold
    compact_mode: str = "topk"    # topk (global top-C)   | block
    engine: "str | engines.EngineSpec" = "monolithic"  # name or EngineSpec
    consensus_floor: int = 0      # dense-mask fallback floor (0 = off)
    robust_agg: str = "sum"       # sum | trim | median

    def __post_init__(self):
        check_interval("k_frac", self.k_frac, 0.0, 1.0, lo_open=True)
        check_interval("capacity_frac", self.capacity_frac, 0.0, 1.0,
                       lo_open=True)
        check_interval("a_frac", self.a_frac, 0.0, 1.0, lo_open=True)
        if self.a is not None:
            check_at_least("a", self.a, 1)
        check_at_least("bits", self.bits, 1)
        check_at_least("vote_chunk", self.vote_chunk, 1)
        check_at_least("consensus_floor", self.consensus_floor, 0)
        check_choice("vote_mode", self.vote_mode, ("topk", "threshold"))
        check_choice("compact_mode", self.compact_mode, ("topk", "block"))
        check_choice("robust_agg", self.robust_agg, robust_agg.ROBUST_AGG_MODES)
        engines.get(self.engine)   # registered name or EngineSpec

    @property
    def kernels(self) -> bool:
        """Whether phase 2 runs through the fused CUDA kernels (the
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


def _require_ported(cfg: FediACConfig) -> None:
    if cfg.vote_mode != "topk" or cfg.compact_mode != "topk":
        raise NotImplementedError(
            f"vote_mode={cfg.vote_mode!r}, compact_mode={cfg.compact_mode!r}: "
            "only topk/topk is ported yet (ROADMAP: threshold/block modes)")
    if cfg.robust_agg != "sum":
        raise NotImplementedError(
            f"robust_agg={cfg.robust_agg!r} is not ported yet "
            "(ROADMAP: robust_agg trim/median)")


# ---------------------------------------------------------------------------
# Phase 1 and phase 2 over the client stack
# ---------------------------------------------------------------------------

def _vote_counts_stack(u_stack: torch.Tensor, cfg: FediACConfig,
                       keys: torch.Tensor) -> torch.Tensor:
    """Phase 1 over all clients at once: int32 vote counts."""
    scores = u_stack if cfg.vote_chunk == 1 else \
        voting.chunk_scores(u_stack, cfg.vote_chunk)
    return voting.vote_counts_stack(scores, cfg.k(scores.shape[-1]), keys)


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
    computes the masked stochastic quantization and the residual; the
    C-sized consensus gather then reads the already-quantized buffer.

    Draws d uniforms per client (one per coordinate), as the reference's
    fused path does.
    """
    uniforms = prng.uniform(keys, (u_stack.shape[-1],))
    q_dense, residuals = kops.gather_quant_flat(u_stack, uniforms, plan.sel, f)
    return q_dense.index_select(1, plan.idx), residuals.to(u_stack.dtype)


def phase2_compress(cfg: FediACConfig):
    """Pick the phase-2 implementation for this config."""
    if plan_wants_dense_mask(cfg):
        return _client_compress_fused
    return client_compress


def plan_wants_dense_mask(cfg: FediACConfig) -> bool:
    return cfg.kernels and cfg.vote_chunk == 1


def scatter_sum(summed_q: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                cfg: FediACConfig, d: int) -> torch.Tensor:
    """De-compact the aggregated int32 buffer back to a d-vector (still ints)."""
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
    _require_ported(cfg)
    n = u_stack.shape[0]
    # Phase 1: every client votes; the PS sums 0/1 arrays.
    counts = _vote_counts_stack(u_stack, cfg, prng.split(key, 2 * n)[:n])
    delta, residuals = aggregate_from_counts(u_stack, cfg, key, counts, a=a)
    return delta, residuals, counts, round_traffic(cfg, u_stack.shape[1])


def aggregate_from_counts(u_stack: torch.Tensor, cfg: FediACConfig,
                          key: torch.Tensor, counts: torch.Tensor, *, a=None):
    """The rest of :func:`aggregate_stack` after phase 1: scale factor,
    consensus plan, phase 2 and the aggregate, from given vote counts.
    Returns ``(delta, residuals)``."""
    _require_ported(cfg)
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
    q_bufs, residuals = phase2_compress(cfg)(u_stack, cfg, f, q_keys, plan)
    # the PS's pipelined integer addition
    summed, kept = robust_agg.client_sum(q_bufs, cfg)
    delta = (scatter_sum(summed, plan.idx, plan.keep, cfg, d).to(torch.float32)
             / (kept * f))
    return delta, residuals


def aggregate_round(u_stack: torch.Tensor, cfg: FediACConfig, key: torch.Tensor,
                    *, a=None):
    """Run one stacked round on the engine ``cfg.engine`` selects."""
    return engines.run(u_stack, cfg, key, a=a)


def fediac_allreduce(*args, **kwargs):
    """The in-network allreduce form of the round (``torch.distributed``)."""
    raise NotImplementedError("fediac_allreduce is not ported yet "
                              "(ROADMAP A8: distributed)")
