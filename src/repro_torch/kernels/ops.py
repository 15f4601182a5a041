"""Public entry points of the port's kernels, as the round calls them.

The reference's ``kernels/ops.py`` pads every flat vector to a
``(rows, 1024)`` matrix — the TPU's VMEM tiling.  The CUDA kernels take
flat row-major operands and mask their own ragged tail, so these wrappers
only bring scalars to float32 on the operands' device (the kernels read
them from device memory, no host sync) and reshape.

The packed vote wire is the exception where the padding is the format:
its word count is the reference's padded one (:func:`~.ref.wire_groups`),
so the port's words equal the reference's word for word, their number
included.  The kernels still never materialise the padded input.
"""

from __future__ import annotations

import torch

from .bitpack import pack, unpack
from .gather_quant import gather_quant
from .ref import LANES
from .stoch_quant import stoch_quant
from .vote_pack import vote_pack
from .vote_popcount import popcount_accum

__all__ = ["quantize_flat", "gather_quant_flat", "pack_votes", "unpack_votes",
           "count_votes", "pack_votes_threshold"]


def _scalar_f(f, like: torch.Tensor) -> torch.Tensor:
    """``f`` (float or scalar tensor) as a 0-dim float32 tensor on
    ``like``'s device."""
    return torch.as_tensor(f, dtype=torch.float32, device=like.device).reshape(())


def quantize_flat(u: torch.Tensor, uniforms: torch.Tensor, f) -> torch.Tensor:
    """Eq. 1 with scale ``f``: float32 ``[..., L]`` -> int32 ``[..., L]``."""
    return stoch_quant(u, uniforms, _scalar_f(f, u))


def gather_quant_flat(u: torch.Tensor, uniforms: torch.Tensor,
                      sel: torch.Tensor, f, *, out: torch.Tensor | None = None):
    """Fused phase-2 client round: ``(u [N, L] or [L], uniforms like u,
    shared sel uint8 [L], f) -> (q_dense int32, residual float32)``, the
    residual written into ``out`` when given (``u`` itself included).
    The kernel is elementwise and takes row-strided views, so the stream
    engine's ``[N, chunk]`` column chunk of a round goes in as it lies,
    with the slice of the full-width uniform draw
    (:func:`repro_torch.core.streams.uniform_block`) and the chunk's slot
    of the residual stack as ``out``."""
    return gather_quant(u, uniforms, sel, _scalar_f(f, u), out=out)


def pack_votes(mask_flat: torch.Tensor) -> torch.Tensor:
    """Flat 0/1 votes ``[d]`` -> the packed wire, int32 ``[W]`` words."""
    return pack(mask_flat).reshape(-1)


def unpack_votes(words_flat: torch.Tensor, d: int) -> torch.Tensor:
    """Packed words ``[W]`` -> uint8 0/1 votes ``[d]``."""
    return unpack(words_flat.reshape(-1, LANES), d)


def count_votes(words_stack_flat: torch.Tensor, d: int) -> torch.Tensor:
    """``[N, W]`` packed words -> int32 ``[d]`` vote counts (the PS's
    phase-1 reduce)."""
    n = words_stack_flat.shape[0]
    return popcount_accum(words_stack_flat.reshape(n, -1, LANES), d)


def pack_votes_threshold(scores_flat: torch.Tensor, tau) -> torch.Tensor:
    """Fused phase-1 wire build: scores ``[d]`` -> packed words ``[W]`` of
    ``scores >= tau``, with no d-sized vote array in between.  Scores are
    compared in float32, as the reference casts them."""
    return vote_pack(scores_flat.to(torch.float32),
                     _scalar_f(tau, scores_flat)).reshape(-1)
