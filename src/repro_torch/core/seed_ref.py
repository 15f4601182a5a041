"""The frozen seed-revision FediAC round: the regression oracle.

This is the round as the reference first wrote it, before the round plan:
every client votes on its own, recomputes the consensus selection from the
shared counts inside its own compress step, and is compressed one at a
time.  :func:`repro_torch.core.fediac.aggregate_stack` must be bitwise
equal to it in every mode.  Its slowness is the point: do not optimize it.

Selections are stable descending sorts (``lax.top_k``'s order, lower index
first among ties), ``log`` is XLA's (:mod:`.xla_math`) and the draws are
the reference's threefry (:mod:`.prng`), so the oracle is bitwise equal to
the reference's ``aggregate_stack_seed`` as well.
"""

from __future__ import annotations

import torch

from . import compaction, prng, xla_math
from .quantize import dequantize, quantize, scale_factor

__all__ = ["aggregate_stack_seed"]


def _top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _vote_mask_seed(u: torch.Tensor, k: int, key: torch.Tensor) -> torch.Tensor:
    d = u.shape[-1]
    k = min(int(k), d)
    logw = xla_math.log(torch.clamp_min(u.abs().to(torch.float32), 1e-30))
    _, idx = _top_k(logw + prng.gumbel(key, (d,)), k)
    mask = torch.zeros((d,), dtype=torch.uint8, device=u.device)
    mask[idx] = 1
    return mask


def _threshold_vote_mask_seed(u, k, m, alpha):
    d = u.shape[-1]
    k = max(1, min(int(k), d))
    # the float32 pow of two scalars, as the reference evaluates it eagerly
    power = (torch.tensor(float(k), dtype=torch.float32)
             ** torch.tensor(float(alpha), dtype=torch.float32))
    tau = m * power.to(m.device)
    return (u.abs() >= tau).to(torch.uint8)


def _chunk_scores_seed(u, chunk):
    d = u.shape[-1]
    return u.abs().reshape(d // chunk, chunk).amax(dim=-1)


def _consensus_indices_seed(counts: torch.Tensor, a: int, capacity: int):
    d = counts.shape[-1]
    capacity = min(int(capacity), d)
    top, idx = _top_k(counts.to(torch.int32), capacity)
    keep = (top >= a).to(torch.float32)
    return idx.to(torch.int32), keep


def _client_votes_seed(u, cfg, key):
    if cfg.vote_chunk > 1:
        scores = _chunk_scores_seed(u, cfg.vote_chunk)
    else:
        scores = u
    k = cfg.k(scores.shape[-1])
    if cfg.vote_mode == "threshold":
        return _threshold_vote_mask_seed(scores, k, scores.abs().max(),
                                         cfg.alpha)
    return _vote_mask_seed(scores, k, key)


def _block_compress_seed(u, counts, cfg, f, key, a):
    keep, pos = compaction.block_select(counts, a, cfg.block_size,
                                        cfg.capacity_frac)
    uniforms = prng.uniform(key, u.shape)
    q = quantize(torch.where(keep, u, 0.0), f, uniforms)
    q_buf = compaction.block_compact(q, keep, pos, cfg.block_size,
                                     cfg.capacity_frac)
    uploaded = torch.where(keep, dequantize(q, f), 0.0)
    residual = (u - uploaded).to(u.dtype)
    return q_buf, keep, pos, residual


def _client_compress_seed(u, counts, cfg, f, key, a):
    d = u.shape[-1]
    n_chunks = d // cfg.vote_chunk
    capacity = cfg.capacity(n_chunks)
    idx_c, keep_c = _consensus_indices_seed(counts, a, capacity)
    rows = idx_c.long()
    if cfg.vote_chunk > 1:
        u2 = u.reshape(n_chunks, cfg.vote_chunk)
        gathered = u2[rows].to(torch.float32) * keep_c[:, None]
        gathered = gathered.reshape(-1)
    else:
        gathered = compaction.compact(u, idx_c, keep_c).to(torch.float32)
    uniforms = prng.uniform(key, gathered.shape)
    q_buf = quantize(gathered, f, uniforms)
    up = dequantize(q_buf, f).to(u.dtype)
    if cfg.vote_chunk > 1:
        up2 = torch.zeros((n_chunks, cfg.vote_chunk), dtype=u.dtype,
                          device=u.device)
        up2[rows] = (up.reshape(capacity, cfg.vote_chunk)
                     * keep_c[:, None].to(u.dtype))
        uploaded = up2.reshape(-1)
    else:
        uploaded = compaction.scatter_compact(up, idx_c, keep_c, d)
    residual = (u - uploaded).to(u.dtype)
    return q_buf, idx_c, keep_c, residual


def _scatter_sum_seed(summed_q, idx_c, keep_c, cfg, d):
    n_chunks = d // cfg.vote_chunk
    capacity = idx_c.shape[0]
    if cfg.vote_chunk > 1:
        out = torch.zeros((n_chunks, cfg.vote_chunk), dtype=summed_q.dtype,
                          device=summed_q.device)
        out[idx_c.long()] = (summed_q.reshape(capacity, cfg.vote_chunk)
                             * keep_c[:, None].to(summed_q.dtype))
        return out.reshape(-1)
    return compaction.scatter_compact(summed_q, idx_c, keep_c, d)


def aggregate_stack_seed(u_stack: torch.Tensor, cfg, key: torch.Tensor):
    """The seed-revision Algo. 1 over stacked ``[N, d]`` updates, one client
    at a time.  Returns ``(delta, residuals, counts)``; the traffic account
    is static and the same as the engine's."""
    n, d = u_stack.shape
    keys = prng.split(key, 2 * n)
    vote_keys, q_keys = keys[:n], keys[n:]
    votes = torch.stack([_client_votes_seed(u_stack[i], cfg, vote_keys[i])
                         for i in range(n)])
    counts = votes.to(torch.int32).sum(dim=0, dtype=torch.int32)
    m = u_stack.abs().max()
    sf = torch.tensor(scale_factor(cfg.bits, n, 1.0), dtype=torch.float32,
                      device=u_stack.device)
    f = sf / torch.clamp_min(m, 1e-12)
    a = cfg.threshold(n)
    compress = (_block_compress_seed if cfg.compact_mode == "block"
                else _client_compress_seed)
    outs = [compress(u_stack[i], counts, cfg, f, q_keys[i], a)
            for i in range(n)]
    q_bufs = torch.stack([o[0] for o in outs])
    residuals = torch.stack([o[3] for o in outs])
    summed = q_bufs.sum(dim=0, dtype=torch.int32)
    if cfg.compact_mode == "block":
        keep, pos = outs[0][1], outs[0][2]
        delta = compaction.block_scatter(summed, keep, pos, d, cfg.block_size,
                                         cfg.capacity_frac)
    else:
        delta = _scatter_sum_seed(summed, outs[0][1], outs[0][2], cfg, d)
    return delta.to(torch.float32) / (n * f), residuals, counts
