"""Fused threshold vote + bit-pack: the sort-free packed wire in one pass.

Replaces the reference's Pallas kernel ``kernels/vote_pack.py::
_vote_pack_kernel`` (launched by ``vote_pack``) with ``csrc/votes.cu::
vote_pack_kernel``.  ``fediac_allreduce`` calls it on the packed wire in
threshold mode with the fused kernels on: bit r of word (g, l) is
``scores[(32g + r)·1024 + l] >= tau``, with no d-sized vote array in
between.

Indices >= d are the reference's -inf padding (they vote only when
``tau`` is -inf); NaN never votes.  ``tau`` is a float32 device scalar the
kernel reads itself, so no host sync precedes the launch.

Bound: device-memory bytes, 4·d read and 4·W written (W = G·1024 words).
One thread per word walks its 32 rows, coalesced across lanes.
"""

from __future__ import annotations

import math

import torch

from . import build
from .bitpack import _device, _padded
from .ref import LANES, vote_pack_ref, wire_groups

__all__ = ["vote_pack", "vote_pack_plain"]


def vote_pack_plain(scores: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The plain-torch version: pad with -inf, then ``ref.vote_pack_ref``."""
    return vote_pack_ref(_padded(scores, wire_groups(scores.numel()),
                                 -math.inf), tau)


def vote_pack(scores: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``(scores float32 [d], tau float32 scalar tensor) -> int32
    [G, 1024]`` words of the mask ``scores >= tau``.

    CPU tensors take :func:`vote_pack_plain`; CUDA tensors launch the
    kernel (and count it in ``vote_pack.launches``) or raise.
    """
    if scores.dtype != torch.float32 or tau.dtype != torch.float32:
        raise TypeError("vote_pack takes float32 scores and tau")
    if scores.dim() != 1 or tau.numel() != 1:
        raise ValueError(f"vote_pack shapes: scores {tuple(scores.shape)}, "
                         f"tau {tuple(tau.shape)}")
    if scores.device != tau.device:
        raise ValueError("vote_pack operands must share one device")
    if _device(scores, "vote_pack") == "cpu":
        return vote_pack_plain(scores, tau)
    scores, tau = scores.contiguous(), tau.contiguous()
    d = scores.numel()
    words = torch.empty((wire_groups(d), LANES), dtype=torch.int32,
                        device=scores.device)
    lib = build.library("votes")
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        build.check(lib.repro_vote_pack(scores.data_ptr(), tau.data_ptr(), d,
                                        words.data_ptr(), words.numel(),
                                        stream), "vote_pack")
    vote_pack.launches += 1
    return words


vote_pack.launches = 0
