"""float32 ``log``, ``log1p``, ``sqrt`` and ``cumsum`` exactly as the
reference computes them.

The reference's vote scores are ``log|u| + gumbel`` with
``gumbel = -log(-log(uniform))``.  XLA's CPU backend evaluates ``log`` with
the Cephes polynomial and fused multiply-adds, which differs from torch's
libm by an ulp on ~7% of inputs; through ``-log(-log(.))`` that ulp grows
to millions of ulps near zero, enough to move a vote at the top-k
boundary.  These functions replay XLA's expansions step for step (its
``log`` and ``log1p`` emitters; its ``sqrt`` is correctly rounded, which
torch's CPU ``sqrt`` is not), so the port's vote scores and Gaussian draws
equal the reference's bit for bit on the CPU and on the card alike.

``cumsum`` replays the order in which the reference's float32 prefix sums
(``jnp.cumsum``) add on XLA's CPU backend: a recursive blocked scan, which
neither a sequential sum nor ``torch.cumsum`` matches.  The packet
dataplane's arrival times and FIFO departures are such sums, and a vote
deadline compares them to a float, so their bits decide vote counts.

A fused multiply-add is emulated in float64: the float32 product is exact
there, and only a float64 sum that lands exactly on a float32 rounding
midpoint (about 2^-29 of the cases) can round differently from a true FMA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma", "log", "log1p", "sqrt", "cumsum"]

_TINY = float(np.finfo(np.float32).tiny)
_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
# log1p's small-argument rational approximation (Cephes), highest degree first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553540916102E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_SMALL = 0.41421356237309504880   # sqrt(2) - 1


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (see the module note);
    ``b`` and ``c`` may be float32 scalars."""
    b, c = (torch.as_tensor(v, dtype=torch.float32, device=a.device)
            for v in (b, c))
    return (a.double() * b.double() + c.double()).float()


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log``."""
    t = torch.clamp_min(x, _TINY)                 # cut off denormals
    bits = t.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).float()
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = t < _SQRTHF
    tmp = torch.where(small, t, 0.0)
    t = t - 1.0
    e = e - small.float()
    t = t + tmp
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma(fma(t, p[0], p[1]), t, p[2])
    y1 = fma(fma(t, p[3], p[4]), t, p[5])
    y2 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    t = t - 0.5 * x2
    t = t + y
    t = t + e * _LOG_Q2
    t = torch.where(x == 0, -math.inf, t)
    t = torch.where(x == math.inf, math.inf, t)
    return torch.where(x < 0, math.nan, t)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: Cephes' rational form below sqrt(2) - 1,
    ``log(1 + x)`` above."""
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + (-0.5 * x2 + (x * x2) * small)
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (as XLA's)."""
    return torch.sqrt(x.double()).float()


#: the block of XLA's CPU prefix sum
_SCAN_BLOCK = 16


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    """float32 prefix sums along the last axis, added left to right."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.cumsum(x, axis=dim)`` in XLA's CPU order: a sequential prefix
    inside each block of 16 elements, the block totals scanned by the same
    rule (recursively), then each block's prefix plus the scanned total of
    the blocks before it."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return (_sequential_prefix(x) if n else x.clone()).movedim(-1, dim)
    nb = -(-n // _SCAN_BLOCK)
    # zeros past the end change no earlier prefix
    padded = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    p = _sequential_prefix(padded.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    before = cumsum(p[..., -1], -1)[..., :-1, None]
    p = torch.cat([p[..., :1, :], before + p[..., 1:, :]], dim=-2)
    return p.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n].movedim(-1, dim)
