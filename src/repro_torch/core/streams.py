"""Slices of the round's random streams, drawn without the whole stream.

``prng.uniform(key, (d,))`` materialises all d values.  The streaming
engine (:mod:`.stream_engine`) needs only one chunk of such a draw at a
time, and the same bits as the whole draw, or its round would stop being
bitwise equal to the monolithic one.  Threefry is counter-based, so the
bits at index ``i`` of a ``total``-sized draw are a function of ``(key,
i, total)`` alone.  This module rebuilds the count pair of each index in
jax's two generation layouts:

* **partitionable** (jax's default, the layout of :mod:`.prng`): index
  ``i`` hashes the pair ``(i >> 32, i & 0xffffffff)``, which is ``(0, i)``
  for any ``total < 2**32``, and keeps the XOR of the two output lanes;
* **legacy** (``jax_threefry_partitionable=False``): the ``total``
  counters are split in half (an odd total pads one zero counter), pair
  ``p`` is ``(p, h + p)`` with ``h = ceil(total / 2)``, and the output is
  the two lanes one after the other, so index ``i`` is lane 0 of pair
  ``i`` when ``i < h`` and lane 1 of pair ``i - h`` otherwise.

The port has no jax configuration to read, so the layout is the
``partitionable`` keyword, True by default.  ``key`` may carry leading
dimensions (a batch of keys, jax's ``vmap`` over keys):
``uniform_block(keys[N, 2], start, size, total)`` is ``[N, size]``.
Each function is bitwise equal to the same slice of the whole draw.
"""

from __future__ import annotations

import torch

from . import prng

__all__ = ["uniform_block", "uniform_at", "gumbel_block"]


def _bits_at(key: torch.Tensor, j: torch.Tensor, total: int,
             partitionable: bool) -> torch.Tensor:
    """32 random bits at the int64 indices ``j`` (each in ``[0, total)``)
    of a ``total``-sized draw: ``[..., len(j)]`` for keys ``[..., 2]``."""
    if partitionable:
        b1, b2 = prng.hash_pairs(key, torch.zeros_like(j), j)
        return b1 ^ b2
    h = -(-int(total) // 2)
    first = j < h
    a = torch.where(first, j, j - h)
    b = torch.where(first, j + h, j)
    b = torch.where(b < total, b, 0)     # the odd total's zero pad
    b1, b2 = prng.hash_pairs(key, a, b)
    return torch.where(first, b1, b2)


def _bits_block(key: torch.Tensor, start: int, size: int, total: int,
                partitionable: bool) -> torch.Tensor:
    j = torch.arange(int(start), int(start) + int(size), dtype=torch.int64,
                     device=key.device)
    return _bits_at(key, j, total, partitionable)


def uniform_block(key: torch.Tensor, start: int, size: int, total: int, *,
                  partitionable: bool = True) -> torch.Tensor:
    """float32 ``[..., size]``: ``prng.uniform(key, (total,))[...,
    start:start + size]`` (jax's ``uniform`` in the chosen layout).

    Each call hashes its own pairs, so streaming a whole vector in chunks
    costs what the one draw does in the partitionable layout, and twice
    that in the legacy one (both lanes of every touched pair)."""
    return prng.uniform_from_bits(
        _bits_block(key, start, size, total, partitionable))


def uniform_at(key: torch.Tensor, idx: torch.Tensor, total: int, *,
               partitionable: bool = True) -> torch.Tensor:
    """float32 ``prng.uniform(key, (total,))[..., idx]`` for an integer
    index tensor (entries in ``[0, total)``, any order, repeats allowed):
    the gather form of :func:`uniform_block`."""
    j = torch.as_tensor(idx, device=key.device).to(torch.int64)
    return prng.uniform_from_bits(_bits_at(key, j, total, partitionable))


def gumbel_block(key: torch.Tensor, start: int, size: int, total: int, *,
                 partitionable: bool = True) -> torch.Tensor:
    """float32 ``[..., size]``: ``prng.gumbel(key, (total,))[...,
    start:start + size]``, through the same uniform-to-Gumbel map and
    XLA ``log`` replay as the whole draw."""
    return prng.gumbel_from_bits(
        _bits_block(key, start, size, total, partitionable))
