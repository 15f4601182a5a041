"""Bit-pack a 0/1 vote mask into the packed wire's words, and back.

Replaces the reference's Pallas kernels ``kernels/bitpack.py::_pack_kernel``
(launched by ``pack``) and ``::_unpack_kernel`` (launched by ``unpack``)
with ``csrc/votes.cu::pack_kernel`` and ``::unpack_kernel``.  The packed
wire of ``fediac_allreduce`` calls ``pack`` on every client's votes; no
round calls ``unpack``.

The layout is the reference's wire format (:mod:`.ref`): a flat d-vector
is viewed as rows of 1024 lanes padded to :func:`~.ref.wire_groups` word
rows, and bit r of word (g, l) holds element (32g + r)·1024 + l.  The
kernels take the flat d-vector and treat every index >= d as padding, so
no padded copy is made.

Bound: device-memory bytes.  ``pack`` reads d bytes and writes 4·W
(W = G·1024 words); ``unpack`` reads 4·W and writes d bytes.  One thread
per word walks its 32 rows, coalesced across lanes.
"""

from __future__ import annotations

import torch

from . import build
from .ref import GROUP, LANES, pack_ref, unpack_ref, wire_groups

__all__ = ["pack", "pack_plain", "unpack", "unpack_plain"]


def _padded(x: torch.Tensor, groups: int, fill) -> torch.Tensor:
    """``x`` padded with ``fill`` to ``groups * 32`` rows of 1024 lanes."""
    out = torch.full((groups * GROUP * LANES,), fill, dtype=x.dtype,
                     device=x.device)
    out[:x.numel()] = x
    return out.reshape(-1, LANES)


def pack_plain(mask: torch.Tensor) -> torch.Tensor:
    """The plain-torch version of ``pack``: zero-pad, then ``ref.pack_ref``."""
    return pack_ref(_padded(mask, wire_groups(mask.numel()), 0))


def unpack_plain(words: torch.Tensor, d: int) -> torch.Tensor:
    """The plain-torch version of ``unpack``: ``ref.unpack_ref``, cut to d."""
    return unpack_ref(words).reshape(-1)[:d]


def _device(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no kernel for {t.device}")
    return t.device.type


def pack(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` uint8 or bool ``[d]`` of 0/1 -> int32 ``[G, 1024]`` words
    (the uint32 wire's bit-view), G = ``wire_groups(d)``.

    CPU tensors take :func:`pack_plain`; CUDA tensors launch the kernel
    (and count it in ``pack.launches``) or raise.
    """
    if mask.dtype not in (torch.uint8, torch.bool) or mask.dim() != 1:
        raise TypeError(f"pack takes a flat uint8 or bool mask, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if _device(mask, "pack") == "cpu":
        return pack_plain(mask)
    mask = mask.contiguous().view(torch.uint8)
    d = mask.numel()
    words = torch.empty((wire_groups(d), LANES), dtype=torch.int32,
                        device=mask.device)
    lib = build.library("votes")
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        build.check(lib.repro_pack(mask.data_ptr(), d, words.data_ptr(),
                                   words.numel(), stream), "pack")
    pack.launches += 1
    return words


def unpack(words: torch.Tensor, d: int) -> torch.Tensor:
    """int32 ``[G, 1024]`` words -> uint8 ``[d]`` of 0/1, for any
    d <= 32·G·1024.

    CPU tensors take :func:`unpack_plain`; CUDA tensors launch the kernel
    (and count it in ``unpack.launches``) or raise.
    """
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != LANES:
        raise TypeError(f"unpack takes int32 [G, {LANES}] words, got "
                        f"{words.dtype} {tuple(words.shape)}")
    if not 0 <= d <= words.numel() * GROUP:
        raise ValueError(f"unpack: d={d} does not fit {words.shape[0]} "
                         "word rows")
    if _device(words, "unpack") == "cpu":
        return unpack_plain(words, d)
    words = words.contiguous()
    out = torch.empty((d,), dtype=torch.uint8, device=words.device)
    lib = build.library("votes")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        build.check(lib.repro_unpack(words.data_ptr(), words.numel(),
                                     out.data_ptr(), d, stream), "unpack")
    unpack.launches += 1
    return out


pack.launches = 0
unpack.launches = 0
