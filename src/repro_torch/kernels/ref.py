"""Plain-torch oracles for every kernel of the reference package.

Each function is bitwise equal to its namesake in the reference's
``kernels/ref.py`` on the same inputs.  The pack layout is the reference's
wire format and stays as it is: a flat 0/1 vector is viewed as rows of
``LANES`` (=1024) lanes, and bit ``r`` of word ``(g, l)`` holds
``mask[32 g + r, l]``.  Packed words are uint32 in the reference; torch
holds them as their int32 bit-view.
"""

from __future__ import annotations

import torch

LANES = 1024
GROUP = 32  # rows packed per uint32 word

_M32 = 0xFFFFFFFF


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(GROUP, dtype=torch.int64, device=device)


def pack_ref(mask: torch.Tensor) -> torch.Tensor:
    """0/1 matrix (R, LANES), R % 32 == 0 -> (R//32, LANES) packed words."""
    r, l = mask.shape
    assert r % GROUP == 0
    x = mask.to(torch.int64).reshape(r // GROUP, GROUP, l)
    words = (x << _shifts(mask.device)[None, :, None]).sum(dim=1) & _M32
    return _as_int32_bits(words)


def unpack_ref(words: torch.Tensor) -> torch.Tensor:
    """(G, LANES) packed words -> (G*32, LANES) uint8 of 0/1."""
    g, l = words.shape
    w = words.to(torch.int64) & _M32
    bits = (w[:, None, :] >> _shifts(words.device)[None, :, None]) & 1
    return bits.reshape(g * GROUP, l).to(torch.uint8)


def popcount_accum_ref(words_stack: torch.Tensor) -> torch.Tensor:
    """(N, G, LANES) packed votes -> (G*32, LANES) int32 vote counts."""
    n, g, l = words_stack.shape
    w = words_stack.to(torch.int64) & _M32
    bits = (w[:, :, None, :] >> _shifts(w.device)[None, None, :, None]) & 1
    return bits.sum(dim=0).reshape(g * GROUP, l).to(torch.int32)


def stoch_quant_ref(u: torch.Tensor, uniforms: torch.Tensor,
                    f: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding of f*u to int32 (paper Eq. 1)."""
    x = u.to(torch.float32) * f
    lo = torch.floor(x)
    return (lo + (uniforms < (x - lo)).to(torch.float32)).to(torch.int32)


def vote_pack_ref(scores: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Fused threshold-vote + pack: pack_ref(scores >= tau)."""
    return pack_ref(scores >= tau)


def gather_quant_ref(u: torch.Tensor, uniforms: torch.Tensor,
                     sel: torch.Tensor, f: torch.Tensor):
    """Fused masked quantize + residual (FediAC phase-2 client round).

    Returns (q int32, residual fp32): q = sel ? theta(f*u) : 0 and
    residual = u - (sel ? q/f : 0).
    """
    uf = u.to(torch.float32)
    on = sel != 0
    q = torch.where(on, stoch_quant_ref(uf, uniforms, f), 0)
    res = uf - torch.where(on, q.to(torch.float32) / f, 0.0)
    return q, res
