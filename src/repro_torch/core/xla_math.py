"""float32 ``log``, ``log1p``, ``sqrt``, ``pow`` and ``cumsum`` exactly as
the reference computes them.

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

``pow`` is the C library's ``powf`` on XLA's CPU backend (glibc's: a
16-interval table for ``log2``, a 32-entry table for ``exp2``, both with
short polynomials in float64), which torch's ``pow`` misses by an ulp on
about 1% of inputs; it is replayed here step for step in float64 with the
library's constants.  Each step is one rounded float64 operation, the same
on the CPU and the card; where the library contracts a product and a sum
into one fused multiply-add the two can differ by a float64 ulp, which
moves the float32 result only when it lies that close to a rounding
midpoint (about 2^-26 of the cases).

A fused multiply-add is emulated in float64: the float32 product is exact
there, and only a float64 sum that lands exactly on a float32 rounding
midpoint (about 2^-29 of the cases) can round differently from a true FMA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma", "log", "log1p", "sqrt", "pow", "cumsum"]

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


# glibc's powf: log2 over 16 subintervals of [0x3f330000, 2 * that) (each a
# pair 1/c, log2(c)), a degree-5 polynomial for log1p(r) / ln 2, then exp2
# from a 32-entry table of 2^(j/32) and a degree-3 polynomial
_POWF_OFF = 0x3F330000
_POWF_TAB = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POWF_POLY = tuple(float.fromhex(a) for a in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2F_TAB = tuple(float.fromhex(a) for a in (
    "0x1.0000000000000p+0", "0x1.059b0d3158574p+0", "0x1.0b5586cf9890fp+0",
    "0x1.11301d0125b51p+0", "0x1.172b83c7d517bp+0", "0x1.1d4873168b9aap+0",
    "0x1.2387a6e756238p+0", "0x1.29e9df51fdee1p+0", "0x1.306fe0a31b715p+0",
    "0x1.371a7373aa9cbp+0", "0x1.3dea64c123422p+0", "0x1.44e086061892dp+0",
    "0x1.4bfdad5362a27p+0", "0x1.5342b569d4f82p+0", "0x1.5ab07dd485429p+0",
    "0x1.6247eb03a5585p+0", "0x1.6a09e667f3bcdp+0", "0x1.71f75e8ec5f74p+0",
    "0x1.7a11473eb0187p+0", "0x1.82589994cce13p+0", "0x1.8ace5422aa0dbp+0",
    "0x1.93737b0cdc5e5p+0", "0x1.9c49182a3f090p+0", "0x1.a5503b23e255dp+0",
    "0x1.ae89f995ad3adp+0", "0x1.b7f76f2fb5e47p+0", "0x1.c199bdd85529cp+0",
    "0x1.cb720dcef9069p+0", "0x1.d5818dcfba487p+0", "0x1.dfc97337b9b5fp+0",
    "0x1.ea4afa2a490dap+0", "0x1.f50765b6e4540p+0"))
_EXP2F_POLY = tuple(float.fromhex(a) for a in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")      # 0x1.8p+52 / 32
_EXP2F_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")


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


def pow(x: torch.Tensor, y) -> torch.Tensor:
    """XLA's float32 ``x ** y`` on its CPU backend (glibc's ``powf``), for
    positive normal or infinite ``x`` and finite ``y`` (a float32 tensor or
    number): ``log2 x`` from the subinterval's table pair and polynomial,
    ``y log2 x`` in float64, then ``exp2`` by rounding to 1/32 (the
    shift-add), the table entry scaled by its power of two, and the
    polynomial; one float32 rounding at the end, a subnormal result
    flushed to zero as XLA's CPU backend flushes it."""
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    x, y = torch.broadcast_tensors(x.to(torch.float32), y)
    dev = x.device
    ix = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    tmp = (ix - _POWF_OFF) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    # the exponent, (int32) top >> 23 with the sign of bit 31
    k = (top >> 23) - torch.where(top >= 2 ** 31, 512, 0)
    iz = (ix - top) & 0xFFFFFFFF
    z = (iz - torch.where(iz >= 2 ** 31, 2 ** 32, 0)).to(torch.int32).view(
        torch.float32).double()
    tab = torch.tensor(_POWF_TAB, dtype=torch.float64, device=dev)
    invc, logc = tab[i, 0], tab[i, 1]
    a = _POWF_POLY
    r = z * invc - 1.0
    y0 = logc + k.double()
    r2 = r * r
    yy = r * a[0] + a[1]
    p = r * a[2] + a[3]
    r4 = r2 * r2
    q = r * a[4] + y0
    q = p * r2 + q
    ylogx = y.double() * (yy * r4 + q)
    # exp2: ylogx = k/32 + r, |r| <= 1/64
    kd = ylogx + _EXP2F_SHIFT
    kk = kd.view(torch.int64) - int(np.float64(_EXP2F_SHIFT).view(np.int64))
    r = ylogx - (kd - _EXP2F_SHIFT)
    scale = (((kk >> 5) + 1023) << 52).view(torch.float64)
    s = torch.tensor(_EXP2F_TAB, dtype=torch.float64, device=dev)[kk & 31]
    s = s * scale
    c = _EXP2F_POLY
    zz = r * c[0] + c[1]
    r2 = r * r
    w = r * c[2] + 1.0
    w = zz * r2 + w
    out = (w * s).float()
    # XLA runs with subnormal results flushed to zero
    out = torch.where((ylogx <= -150.0) | (out.abs() < _TINY), 0.0, out)
    out = torch.where(ylogx > _EXP2F_OFLOW, math.inf, out)
    # powf's special cases among the inputs it takes here
    out = torch.where(x == math.inf, torch.where(y < 0, 0.0, math.inf), out)
    out = torch.where(y == 0, 1.0, out)
    return torch.where(torch.isnan(x), math.nan, out)


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
