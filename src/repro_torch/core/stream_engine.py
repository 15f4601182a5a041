"""The streaming round engine: one FediAC round in coordinate chunks.

:func:`repro_torch.core.fediac.aggregate_stack` (the monolithic engine)
holds several ``[N, d]`` temporaries at once: the Gumbel scores, the vote
masks, the uniform draw and, since threefry runs as int64 tensor
arithmetic, its 8-byte counters and lanes.  This engine runs the same
round with smaller temporaries and gives the same bits.  Threshold votes
and phase 2 hold ``O(N·chunk)`` temporaries beyond the inputs and outputs.
Top-k phase 1 holds one block of rows' float32 scores and their sort,
``O(rows·d)``, plus the draw's int64 temporaries of one piece
(:data:`.voting.SCORE_PIECE` elements): each client's selection sorts a
whole ``[d]`` row, but the row is drawn in pieces
(:func:`.voting.vote_scores`).  It gives the same bits for three
reasons:

1. integer vote sums are associative.  Threshold votes are local to a
   chunk once each client's max |u| is known (one extra pass); top-k votes
   need each client's global selection, so phase 1 goes over the *client*
   axis instead, a block of ``[d]`` rows at a time (as many as fit
   ``N·chunk`` elements, one at least), with the monolithic selection on
   scores drawn piece by piece;
2. the consensus plan is built once from the counts
   (:func:`.round_plan.build_round_plan`), with the inverse ``slot`` map so
   that a chunk finds its coordinates' compact-buffer slots;
3. chunks cover disjoint coordinates, so every consensus coordinate is
   compressed in exactly one chunk and the client sums (the plain sum, or
   the trim / median close, both column by column) are those of the
   monolithic round.

Phase-2 uniforms are sliced from the monolithic round's draws, never drawn
anew: the fused path (kernels on) and block mode slice each client's
d-sized stream (:func:`.streams.uniform_block`); the plain top-k path draws
the C-sized stream once and gathers it at the chunk's slots.

The chunk loop reads every chunk from the input stack and writes the
residual stack, which no chunk reads: with ``out=u_stack`` the residuals
overwrite the input in place, since phase 1 has finished reading it and a
chunk computes its residual before writing its own columns.

With the kernels on, each chunk is one launch of B1 ``gather_quant`` at
``[N, chunk]`` (:func:`repro_torch.kernels.ops.gather_quant_flat`).  For
a float32 stack it reads the strided column chunk of the stack as it lies
and writes the residual straight into the chunk's columns of the residual
stack (``out=``; with ``out=u_stack`` that is the chunk it read, in
place), so no chunk copies its operands in or its residual out.  Another
dtype is cast to float32 for the launch and its residual cast back and
copied.

``vote_chunk > 1`` is not streamed; that mode keeps the monolithic engine.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.validate import require

from . import compaction, prng, robust_agg, selection, voting
from .fediac import plan_wants_dense_mask, round_traffic
from .quantize import dequantize, quantize, scale_factor
from .round_plan import RoundPlan, build_round_plan
from .streams import uniform_block

__all__ = ["aggregate_stream", "stream_compress_stack", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 1 << 18  # coordinates per chunk (1 MiB of float32 per client)


def _chunk_size(cfg, d: int, chunk: int | None = None) -> int:
    """The chunk size: ``chunk`` or :data:`DEFAULT_CHUNK`, aligned down to
    the block granule in block mode so that no block straddles two chunks
    (each chunk's block compaction is then that of its own blocks)."""
    c = int(chunk if chunk is not None else DEFAULT_CHUNK)
    if cfg.compact_mode == "block":
        bs = int(cfg.block_size)
        c = max(bs, c - c % bs)
    return max(1, min(c, d))


def _check_streamable(cfg) -> None:
    if cfg.vote_chunk != 1:
        raise NotImplementedError(
            "the streaming engine requires vote_chunk == 1 "
            "(chunked vote bits keep the monolithic engine)")


# ---------------------------------------------------------------------------
# Phase 1: vote counts and the global max |u|
# ---------------------------------------------------------------------------

def _phase1_threshold(u_stack: torch.Tensor, cfg, chunk: int):
    """Threshold votes: each client's max |u| over the chunks, its tau
    (the eager :func:`.voting.vote_tau`, as the monolithic round's), then
    the int32 count of ``|u| >= tau`` chunk by chunk."""
    n, d = u_stack.shape
    k = max(1, min(cfg.k(d), d))
    m_vec = torch.zeros((n,), dtype=u_stack.dtype, device=u_stack.device)
    for start in range(0, d, chunk):
        u_c = u_stack[:, start:start + chunk]
        m_vec = torch.maximum(m_vec, u_c.abs().amax(dim=1))
    tau = voting.vote_tau(m_vec, k, cfg.alpha).unsqueeze(-1)
    counts = torch.empty((d,), dtype=torch.int32, device=u_stack.device)
    for start in range(0, d, chunk):
        u_c = u_stack[:, start:start + chunk]
        counts[start:start + chunk] = (u_c.abs().to(torch.float32) >= tau).sum(
            dim=0, dtype=torch.int32)
    return counts, m_vec.max()


def _phase1_topk(u_stack: torch.Tensor, cfg, vote_keys: torch.Tensor,
                 chunk: int):
    """Gumbel top-k votes over blocks of client rows: a row's k-th score
    is global over d, so this phase goes over the clients, as many rows a
    step as fit one chunk's N·chunk elements (one row at least), its
    scores drawn in pieces.  Client i's draw under its own key is row i
    of the monolithic ``[N, d]`` draw, and the int32 counts add up in any
    grouping."""
    n, d = u_stack.shape
    k = min(cfg.k(d), d)
    rows = max(1, n * chunk // d)
    counts = torch.zeros((d,), dtype=torch.int32, device=u_stack.device)
    m = torch.zeros((), dtype=u_stack.dtype, device=u_stack.device)
    for i in range(0, n, rows):
        block = u_stack[i:i + rows]
        scores = voting.vote_scores(block, vote_keys[i:i + rows],
                                    piece=voting.SCORE_PIECE)
        counts += selection.topk_counts_stack(scores, k)
        del scores
        m = torch.maximum(m, block.abs().max())
    return counts, m


# ---------------------------------------------------------------------------
# Phase 2: compress one chunk of every client, write its residual
# ---------------------------------------------------------------------------

def _topk_chunk(u_c, cfg, f, q_keys, plan: RoundPlan, uq_all, start: int,
                d: int, res_c):
    """One chunk of top-k phase 2 for all clients: ``(q, residual)``, both
    ``[N, size]``.  ``q`` is 0 wherever the coordinate is not a kept
    consensus coordinate, and equals the compact buffer's entry at that
    coordinate's slot elsewhere.  The fused path on a float32 stack
    (row-major, as stacks are) writes the residual into ``res_c``, the
    chunk's columns of the residual stack, and returns it."""
    size = u_c.shape[1]
    dt = u_c.dtype
    sel_c = plan.sel[start:start + size]
    if uq_all is None:   # fused: B1 on the slice of the d-sized stream
        uni = uniform_block(q_keys, start, size, d)
        if dt == torch.float32 and u_c.stride(1) == 1 == res_c.stride(1):
            return kops.gather_quant_flat(u_c, uni, sel_c, f, out=res_c)
        q, res = kops.gather_quant_flat(
            u_c.to(torch.float32).contiguous(), uni, sel_c, f)
        return q, res.to(dt)
    uni = uq_all.index_select(1, plan.slot[start:start + size])
    keep_c = sel_c.to(torch.float32)
    # client_compress's cast chain: compact in u's dtype, quantize in f32
    gathered = (u_c.to(torch.float32) * keep_c).to(dt).to(torch.float32)
    q = quantize(gathered, f, uni)
    vals = (dequantize(q, f).to(dt).to(torch.float32) * keep_c).to(dt)
    return q, u_c - vals


def _block_chunk(u_c, f, q_keys, plan: RoundPlan, start: int, d: int):
    """One chunk of block-mode phase 2 for all clients: ``(q, residual)``,
    as the monolithic ``_block_compress_dense`` computes them."""
    size = u_c.shape[1]
    keep_c = plan.keep_dense[start:start + size]
    uni = uniform_block(q_keys, start, size, d)
    q = quantize(torch.where(keep_c, u_c, 0.0), f, uni)
    return q, u_c - torch.where(keep_c, dequantize(q, f), 0.0)


def _compress_chunks(u_stack, cfg, f, q_keys, plan: RoundPlan, chunk: int,
                     residuals: torch.Tensor):
    """Phase 2 chunk by chunk: writes each chunk's residual into
    ``residuals`` and yields ``(start, size, q)``.  Chunks read only
    ``u_stack``, so ``residuals`` may be ``u_stack`` itself."""
    n, d = u_stack.shape
    block = cfg.compact_mode == "block"
    uq_all = None
    if not block and not plan_wants_dense_mask(cfg):
        uq_all = prng.uniform(q_keys, (plan.capacity,))
    for start in range(0, d, chunk):
        u_c = u_stack[:, start:start + chunk]
        res_c = residuals[:, start:start + chunk]
        if block:
            q, res = _block_chunk(u_c, f, q_keys, plan, start, d)
        else:
            q, res = _topk_chunk(u_c, cfg, f, q_keys, plan, uq_all, start, d,
                                 res_c)
        if res is not res_c:
            res_c.copy_(res)
        yield start, u_c.shape[1], q


def _residual_buffer(u_stack: torch.Tensor, out) -> torch.Tensor:
    if out is None:
        return torch.empty_like(u_stack, memory_format=torch.contiguous_format)
    require(out.shape == u_stack.shape and out.dtype == u_stack.dtype
            and out.device == u_stack.device, "out",
            f"shaped {tuple(u_stack.shape)}, {u_stack.dtype} on "
            f"{u_stack.device}", f"{tuple(out.shape)}, {out.dtype} on "
            f"{out.device}")
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def aggregate_stream(u_stack: torch.Tensor, cfg, key: torch.Tensor, *, a=None,
                     chunk: int | None = None, out: torch.Tensor | None = None):
    """One FediAC round in coordinate chunks, bitwise equal to
    :func:`repro_torch.core.fediac.aggregate_stack` (same arguments, same
    ``(delta, residuals, counts, TrafficStats)``) in every vote and
    compact mode, with the kernels on or off and every client-axis close.

    ``chunk`` coordinates per chunk (default :data:`DEFAULT_CHUNK`; block
    mode aligns it to ``block_size``).  ``out`` takes the residuals: a
    buffer shaped like ``u_stack`` that shares no memory with it, or
    ``u_stack`` itself, which the round then overwrites with its
    residuals (no second ``[N, d]`` buffer).
    """
    n, d = u_stack.shape
    _check_streamable(cfg)
    chunk = _chunk_size(cfg, d, chunk)
    keys = prng.split(key, 2 * n)
    vote_keys, q_keys = keys[:n], keys[n:]
    if cfg.vote_mode == "threshold":
        counts, m = _phase1_threshold(u_stack, cfg, chunk)
    else:
        counts, m = _phase1_topk(u_stack, cfg, vote_keys, chunk)
    # f as the monolithic round computes it: a float32 device tensor
    # divided by the device max (tensor / tensor, bitwise on the card)
    sf = torch.tensor(scale_factor(cfg.bits, n, 1.0), dtype=torch.float32,
                      device=u_stack.device)
    f = sf / torch.clamp_min(m, 1e-12)
    topk = cfg.compact_mode != "block"
    plan = build_round_plan(counts, cfg, n, a=a, with_dense_mask=topk,
                            with_slot_map=topk)
    residuals = _residual_buffer(u_stack, out)
    chunks = _compress_chunks(u_stack, cfg, f, q_keys, plan, chunk, residuals)
    if topk:
        # the dense int32 client sum; the C consensus slots are read back
        qsum = torch.empty((d,), dtype=torch.int32, device=u_stack.device)
        for start, size, q in chunks:
            qsum[start:start + size] = robust_agg.client_sum(q, cfg)[0]
        kept = robust_agg.kept_count(cfg, n, device=u_stack.device)
        summed = qsum.index_select(0, plan.idx)
        delta = (compaction.scatter_compact(summed, plan.idx, plan.keep, d)
                 .to(torch.float32) / (kept * f))
    else:
        delta = torch.empty((d,), dtype=torch.float32, device=u_stack.device)
        for start, size, q in chunks:
            qagg, kept = robust_agg.client_sum(q, cfg)
            keep_c = plan.keep_dense[start:start + size]
            delta[start:start + size] = (torch.where(keep_c, qagg, 0)
                                         .to(torch.float32) / (kept * f))
    return delta, residuals, counts, round_traffic(cfg, d)


def stream_compress_stack(u_stack: torch.Tensor, cfg, f: torch.Tensor,
                          q_keys: torch.Tensor, plan: RoundPlan, *,
                          chunk: int | None = None):
    """Phase 2 in chunks, returning every client's compact buffer:
    ``(q_bufs int32[N, C], residuals [N, d])``, bitwise equal to the
    stacked phase-2 compress (:func:`repro_torch.core.fediac
    .phase2_compress`) against the same plan.  For the packet dataplane,
    which aggregates each client's buffer.

    In top-k mode ``plan`` must carry the dense mask and the slot map
    (``build_round_plan(..., with_dense_mask=True, with_slot_map=True)``).
    """
    n, d = u_stack.shape
    _check_streamable(cfg)
    chunk = _chunk_size(cfg, d, chunk)
    residuals = _residual_buffer(u_stack, None)
    chunks = _compress_chunks(u_stack, cfg, f, q_keys, plan, chunk, residuals)
    if cfg.compact_mode == "block":
        # blocks never straddle chunks: each chunk's buffers are the
        # full buffers' columns of its own blocks
        q_bufs = torch.cat([compaction.block_compact(
            q, plan.keep_dense[start:start + size],
            plan.pos[start:start + size], cfg.block_size, cfg.capacity_frac)
            for start, size, q in chunks], dim=1)
        return q_bufs, residuals
    q_bufs = torch.zeros((n, plan.capacity), dtype=torch.int32,
                         device=u_stack.device)
    for start, size, q in chunks:
        # q is 0 off the kept coordinates, so the dummy slot-0 adds of
        # the others add nothing
        q_bufs.index_add_(1, plan.slot[start:start + size], q)
    return q_bufs, residuals
