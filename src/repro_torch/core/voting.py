"""Phase 1 of FediAC: magnitude-proportional client voting and GIA deduction.

Each client votes ``k`` coordinates of its update vector with odds
proportional to |U_l| (paper Sec. IV step 1 / Eq. 2-3), sampled without
replacement by the Gumbel-top-k trick: ``argtop_k(log w + Gumbel noise)``.
The PS sums the 0/1 arrays and thresholds at ``a`` votes to produce the
Global Index Array (Sec. IV step 2).

With ``vote_chunk`` g > 1 one vote bit covers a chunk of g contiguous
coordinates, scored by the chunk's max magnitude.

Only top-k voting is ported; threshold voting is queued in ROADMAP.
"""

from __future__ import annotations

import torch

from . import prng, selection, xla_math

__all__ = ["vote_scores", "vote_counts_stack", "chunk_scores",
           "gia_from_counts"]


def chunk_scores(u: torch.Tensor, chunk: int) -> torch.Tensor:
    """Max-|.| score per chunk of g contiguous coordinates (g | d required),
    along the last axis."""
    d = u.shape[-1]
    if d % chunk:
        raise ValueError(f"chunk {chunk} must divide d {d}")
    return u.abs().reshape(*u.shape[:-1], d // chunk, chunk).amax(dim=-1)


def vote_scores(u: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Gumbel-perturbed log-magnitude scores whose top-k is the vote.

    ``u`` is ``[d]`` with one key, or ``[N, d]`` with ``keys[N, 2]``.  The
    ``log`` is XLA's (:mod:`.xla_math`), so the scores equal the
    reference's bit for bit.
    """
    logw = xla_math.log(torch.clamp_min(u.abs().to(torch.float32), 1e-30))
    return logw + prng.gumbel(key, (u.shape[-1],))


def vote_counts_stack(u_stack: torch.Tensor, k: int, keys: torch.Tensor) -> torch.Tensor:
    """Phase-1 PS reduction: int32[d] counts of the N clients' votes."""
    k = min(int(k), u_stack.shape[-1])
    return selection.topk_counts_stack(vote_scores(u_stack, keys), k)


def gia_from_counts(counts: torch.Tensor, a: int) -> torch.Tensor:
    """GIA: 1 where at least ``a`` clients voted (Sec. IV step 2)."""
    return (counts >= a).to(torch.uint8)
