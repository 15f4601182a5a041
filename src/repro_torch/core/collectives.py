"""The client-axis collectives of the in-network allreduce.

The reference runs ``fediac_allreduce`` inside ``shard_map``, where the
clients are mesh axes and ``jax.lax.axis_index``, ``psum``, ``pmax``,
``all_gather`` and ``compat.axis_size`` act over them.  Here every client is
one rank of a ``torch.distributed`` process group, and these functions are
those collectives on that group (``None`` is the default group).

Backends: on NCCL every operand stays on the card.  NCCL refuses two ranks
on one device, so the ranks that share one card run over gloo, which takes
CUDA tensors and stages them through host memory itself; the compute
around the collectives stays on the card either way.

The callers keep the reference's wire dtypes: uint8 votes on the count
wire (a uint8 sum wraps past 255 clients, as the reference's does), int32
packed words and phase-2 buffers, and a float32 (or working-dtype) max.
Integer sums are exact in any order, and a max is order-free, so every
rank holds the same bits after each call.  A float sum is not: gloo's
reduction order varies along the vector, so float sums go through
:func:`psum_in_order`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["rank", "size", "psum_", "psum_in_order", "pmax_", "all_gather"]


def rank(group=None) -> int:
    """This client's index along the client axis (``axis_index``)."""
    return dist.get_rank(group)


def size(group=None) -> int:
    """The number of clients N (``axis_size``)."""
    return dist.get_world_size(group)


def psum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the clients in place (``psum``); returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def psum_in_order(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the clients in rank order from +0.0, ``((0 + t_0) + t_1)
    + ...``: the order of the reference's host all-reduce (a column of
    -0.0 sums to +0.0), the same on every rank and backend.  Gathers all N
    operands first."""
    parts = all_gather(t, group)
    total = torch.zeros_like(parts[0])
    for part in parts:
        total += part
    return total


def pmax_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max of ``t`` over the clients in place (``pmax``);
    returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every client's ``t`` stacked in rank order: ``[N, *t.shape]``."""
    t = t.contiguous()
    out = torch.empty((size(group), *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t, group=group)
    return out
