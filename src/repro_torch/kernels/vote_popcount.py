"""Popcount-accumulate of N clients' packed votes: the switch's phase-1 sum
on the packed wire.

Replaces the reference's Pallas kernel ``kernels/vote_popcount.py::
_popcount_kernel`` (launched by ``popcount_accum``) with
``csrc/votes.cu::popcount_kernel``.  Every packed round of
``fediac_allreduce`` calls it on the all-gathered words:
``out[(32g + r)·1024 + l] = Σ_n bit r of words[n, g, l]``, for the first
d coordinates only (``ops.count_votes``'s ``[:d]``).

Bound: device-memory bytes, 4·N·W read and 4·d written.  One thread per
word position loops over the N clients with 32 counters in registers and
writes its 32 counts coalesced across lanes; no client's bit planes are
ever stored.
"""

from __future__ import annotations

import torch

from . import build
from .bitpack import _device
from .ref import GROUP, LANES, popcount_accum_ref

__all__ = ["popcount_accum", "popcount_accum_plain"]


def popcount_accum_plain(words: torch.Tensor, d: int) -> torch.Tensor:
    """The plain-torch version: ``ref.popcount_accum_ref``, cut to d."""
    return popcount_accum_ref(words).reshape(-1)[:d]


def popcount_accum(words: torch.Tensor, d: int) -> torch.Tensor:
    """int32 ``[N, G, 1024]`` packed votes -> int32 ``[d]`` vote counts,
    for any d <= 32·G·1024.

    CPU tensors take :func:`popcount_accum_plain`; CUDA tensors launch the
    kernel (and count it in ``popcount_accum.launches``) or raise.
    """
    if words.dtype != torch.int32 or words.dim() != 3 \
            or words.shape[2] != LANES:
        raise TypeError(f"popcount_accum takes int32 [N, G, {LANES}] words, "
                        f"got {words.dtype} {tuple(words.shape)}")
    if not 0 <= d <= words.shape[1] * LANES * GROUP:
        raise ValueError(f"popcount_accum: d={d} does not fit "
                         f"{words.shape[1]} word rows")
    if _device(words, "popcount_accum") == "cpu":
        return popcount_accum_plain(words, d)
    words = words.contiguous()
    out = torch.empty((d,), dtype=torch.int32, device=words.device)
    n_clients, n_words = words.shape[0], words.shape[1] * LANES
    lib = build.library("votes")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        build.check(lib.repro_popcount(words.data_ptr(), n_clients, n_words,
                                       out.data_ptr(), d, stream),
                    "popcount_accum")
    popcount_accum.launches += 1
    return out


popcount_accum.launches = 0
