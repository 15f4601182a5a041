"""Phase 1 of FediAC: magnitude-proportional client voting and GIA deduction.

Each client votes ``k`` coordinates of its update vector with odds
proportional to |U_l| (paper Sec. IV step 1 / Eq. 2-3), sampled without
replacement by the Gumbel-top-k trick: ``argtop_k(log w + Gumbel noise)``.
The PS sums the 0/1 arrays and thresholds at ``a`` votes to produce the
Global Index Array (Sec. IV step 2).

With ``vote_chunk`` g > 1 one vote bit covers a chunk of g contiguous
coordinates, scored by the chunk's max magnitude.

The sort-free mode votes ``|u| >= tau`` instead, with ``tau`` the Def. 1
power-law estimate of the k-th largest magnitude (:func:`vote_tau`).
"""

from __future__ import annotations

import torch

from . import prng, selection, xla_math

__all__ = ["vote_mask", "vote_scores", "vote_mask_stack", "vote_counts_stack",
           "vote_tau", "threshold_vote_mask", "chunk_scores",
           "gia_from_counts"]


def chunk_scores(u: torch.Tensor, chunk: int) -> torch.Tensor:
    """Max-|.| score per chunk of g contiguous coordinates (g | d required),
    along the last axis."""
    d = u.shape[-1]
    if d % chunk:
        raise ValueError(f"chunk {chunk} must divide d {d}")
    return u.abs().reshape(*u.shape[:-1], d // chunk, chunk).amax(dim=-1)


def vote_tau(m: torch.Tensor, k: int, alpha: float, *,
             staged: bool = False) -> torch.Tensor:
    """Def. 1 power-law estimate of the k-th largest magnitude:
    |U{l}| ~= m * l^alpha  =>  tau = m * k^alpha, float32 on m's device.

    The single source of the threshold: the fused ``vote_pack`` wire and
    :func:`threshold_vote_mask` must use the same tau or clients diverge,
    and one ulp of tau flips every vote inside that ulp.  So ``k^alpha`` is
    the float32 ``pow`` the reference evaluates.  Called eagerly (its
    ``aggregate_stack``), that is XLA's runtime ``pow``, which torch's
    0-dim CPU tensor ``**`` equals (torch's vectorised ``**`` does not).
    Staged (``jit``/``shard_map``: its ``fediac_allreduce``), XLA rewrites
    ``pow(k, -1)`` into the correctly rounded ``1/k``, which ``pow`` misses
    for about one k in a thousand; ``staged=True`` gives that value.
    """
    kt = torch.tensor(float(k), dtype=torch.float32)
    at = torch.tensor(float(alpha), dtype=torch.float32)
    if staged and float(at) == -1.0:
        power = torch.ones((), dtype=torch.float32) / kt
    else:
        power = kt ** at
    return m.to(torch.float32) * power.to(m.device)


def threshold_vote_mask(u: torch.Tensor, k: int, m: torch.Tensor,
                        alpha: float, *, staged: bool = False) -> torch.Tensor:
    """Sort-free voting: uint8 0/1 of ``|u| >= vote_tau(m, k, alpha)``.

    ``u`` is ``[d]`` with a scalar ``m``, or ``[N, d]`` with ``m[N]`` (one
    client per row).  The comparison is in float32, as the reference
    promotes it.
    """
    d = u.shape[-1]
    k = max(1, min(int(k), d))
    tau = vote_tau(m, k, alpha, staged=staged)
    return (u.abs().to(torch.float32) >= tau.unsqueeze(-1)).to(torch.uint8)


def vote_scores(u: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Gumbel-perturbed log-magnitude scores whose top-k is the vote.

    ``u`` is ``[d]`` with one key, or ``[N, d]`` with ``keys[N, 2]``.  The
    ``log`` is XLA's (:mod:`.xla_math`), so the scores equal the
    reference's bit for bit.
    """
    logw = xla_math.log(torch.clamp_min(u.abs().to(torch.float32), 1e-30))
    return logw + prng.gumbel(key, (u.shape[-1],))


def vote_mask(u: torch.Tensor, k: int, key: torch.Tensor) -> torch.Tensor:
    """One client's uint8 0/1 vote array: k coordinates sampled without
    replacement, with probability proportional to |u| (Gumbel-top-k)."""
    k = min(int(k), u.shape[-1])
    return selection.topk_mask(vote_scores(u, key), k)


def vote_mask_stack(u_stack: torch.Tensor, k: int, keys: torch.Tensor) -> torch.Tensor:
    """All N clients' vote masks at once: uint8 ``[N, d]``."""
    k = min(int(k), u_stack.shape[-1])
    return selection.topk_mask_stack(vote_scores(u_stack, keys), k)


def vote_counts_stack(u_stack: torch.Tensor, k: int, keys: torch.Tensor) -> torch.Tensor:
    """Phase-1 PS reduction: int32[d] counts of the N clients' votes."""
    k = min(int(k), u_stack.shape[-1])
    return selection.topk_counts_stack(vote_scores(u_stack, keys), k)


def gia_from_counts(counts: torch.Tensor, a: int) -> torch.Tensor:
    """GIA: 1 where at least ``a`` clients voted (Sec. IV step 2)."""
    return (counts >= a).to(torch.uint8)
