"""Plain-torch oracles for every kernel of the reference package.

Each function is bitwise equal to its namesake in the reference's
``kernels/ref.py`` on the same inputs.  The pack layout is the reference's
wire format and stays as it is: a flat 0/1 vector is viewed as rows of
``LANES`` (=1024) lanes, and bit ``r`` of word ``(g, l)`` holds
``mask[32 g + r, l]``.  Packed words are uint32 in the reference; torch
holds them as their int32 bit-view.

The bit functions walk the 32 bit positions one plane at a time, so their
largest temporary is one word-sized plane: they also serve as the plain
versions of the wire kernels at full width on the card.
"""

from __future__ import annotations

import torch

LANES = 1024
GROUP = 32        # rows packed per uint32 word
PAD_ROWS = 256    # the reference pads the row count to a multiple of this


def wire_groups(d: int) -> int:
    """Word rows G of the packed wire for a d-vector: the reference's
    ``ops._to_rows`` pads ceil(d / LANES) rows up to a multiple of
    ``PAD_ROWS``, and 32 rows make one row of words.  ``G * LANES`` is the
    wire's word count."""
    rows = -(-d // LANES)
    rows += (-rows) % PAD_ROWS
    return rows // GROUP


def pack_ref(mask: torch.Tensor) -> torch.Tensor:
    """0/1 matrix (R, LANES), R % 32 == 0 -> (R//32, LANES) packed words."""
    r, l = mask.shape
    assert r % GROUP == 0
    x = (mask != 0).to(torch.int32).reshape(r // GROUP, GROUP, l)
    words = torch.zeros((r // GROUP, l), dtype=torch.int32, device=mask.device)
    for b in range(GROUP):
        words |= x[:, b, :] << b
    return words


def unpack_ref(words: torch.Tensor) -> torch.Tensor:
    """(G, LANES) packed words -> (G*32, LANES) uint8 of 0/1."""
    g, l = words.shape
    out = torch.empty((g, GROUP, l), dtype=torch.uint8, device=words.device)
    for b in range(GROUP):
        out[:, b, :] = (words >> b) & 1
    return out.reshape(g * GROUP, l)


def popcount_accum_ref(words_stack: torch.Tensor) -> torch.Tensor:
    """(N, G, LANES) packed votes -> (G*32, LANES) int32 vote counts."""
    n, g, l = words_stack.shape
    out = torch.empty((g, GROUP, l), dtype=torch.int32, device=words_stack.device)
    for b in range(GROUP):
        out[:, b, :] = ((words_stack >> b) & 1).sum(dim=0, dtype=torch.int32)
    return out.reshape(g * GROUP, l)


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
