"""Baseline allreduces: the paper's SwitchML and Top-k as collectives.

The FL simulator (:mod:`.baselines`) runs the baselines over a stacked
``[N, d]`` update; these are their collective forms, with the signature
of :func:`.fediac.fediac_allreduce` ``(u, residual, key, cfg, group)``:
one client per rank of a ``torch.distributed`` group (``None`` is the
default group), where the reference runs one client per device of a
``shard_map`` mesh axis.  Each returns ``(mean_update, new_residual)``,
the same mean on every rank.

* :func:`switchml_allreduce`, SwitchML [NSDI'21]: dense unbiased integer
  quantization, no sparsification and no residual.
* :func:`topk_allreduce`: per-client Top-k with error feedback, without
  consensus.  The clients' index sets differ, so the sparse vectors are
  summed densely: the wire costs what dense FedAvg's does (the paper's
  Sec. III-B motivation in collective form).
"""

from __future__ import annotations

import torch

from . import collectives, prng, selection
from .quantize import dequantize, quantize, scale_factor

__all__ = ["switchml_allreduce", "topk_allreduce"]


def _n_tensor(n: int, device) -> torch.Tensor:
    # the reference's `x / n`: a float32 division by float32(n), kept
    # tensor / tensor (torch turns `x / python scalar` into a reciprocal
    # multiply on the card)
    return torch.tensor(float(n), dtype=torch.float32, device=device)


def switchml_allreduce(u: torch.Tensor, residual: torch.Tensor,
                       key: torch.Tensor, cfg=None, group=None):
    """Dense b-bit integer aggregation (``cfg.bits``, 12 without a cfg):
    ``(mean of the de-quantized sum, zeros)``."""
    n = collectives.size(group)
    bits = cfg.bits if cfg is not None else 12
    u = (u + residual).to(torch.float32)
    m = collectives.pmax_(u.abs().max(), group)
    sf = torch.tensor(scale_factor(bits, n, 1.0), dtype=torch.float32,
                      device=u.device)
    f = sf / torch.clamp_min(m, 1e-12)
    uniforms = prng.uniform(prng.fold_in(key, collectives.rank(group)),
                            u.shape)
    q = quantize(u, f, uniforms)
    # The reference's wire is the narrowest integer that holds the N-client
    # sum of b-bit values: int16 up to 15 bits, else int32.  Neither gloo
    # nor NCCL sums int16, so the sum runs in int32 always; it holds the
    # same exact integers.
    summed = collectives.psum_(q, group)
    mean = dequantize(summed, f) / _n_tensor(n, u.device)
    return mean, torch.zeros_like(residual)


def topk_allreduce(u: torch.Tensor, residual: torch.Tensor, key: torch.Tensor,
                   cfg=None, group=None):
    """Per-client Top-k (``cfg.k_frac`` of d, 5% without a cfg) with error
    feedback, summed densely: ``(mean of the sparse vectors, u + residual
    off the client's top-k)``.  ``key`` is unused (Top-k draws nothing)."""
    n = collectives.size(group)
    k_frac = cfg.k_frac if cfg is not None else 0.05
    d = u.shape[-1]
    k = max(1, int(round(k_frac * d)))
    u = (u + residual).to(torch.float32)
    # lax.top_k's order: lower indices first among equal magnitudes
    idx = selection.topk_indices(u.abs(), k)
    mask = torch.zeros((d,), dtype=torch.float32, device=u.device)
    mask[idx] = 1.0
    sparse = u * mask
    new_residual = (u - sparse).to(residual.dtype)
    # the reference's host all-reduce adds floats in rank order
    mean = collectives.psum_in_order(sparse, group) / _n_tensor(n, u.device)
    return mean, new_residual
