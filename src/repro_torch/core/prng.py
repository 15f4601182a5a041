"""The ``jax.random`` calls of the FediAC round and the FL loop, in torch.

Every draw of the reference comes from threefry-2x32 in jax's
*partitionable* layout (``jax_threefry_partitionable=True``, the default
since jax 0.5): element ``i`` of a ``shape``-sized draw hashes the 64-bit
count ``i`` split into ``(i >> 32, i & 0xffffffff)`` and keeps the XOR of
the two output lanes.  Re-implementing that hash here makes every random
number of the port bit-identical to the reference's, so vote counts,
consensus plans, quantized buffers and residuals can be compared exactly.

A key is an int64 tensor of shape ``(..., 2)`` holding uint32 values.  The
arithmetic runs in int64 masked to 32 bits because torch implements no
shifts on uint32 tensors.  Leading key dimensions act as ``jax.vmap`` over
keys: ``uniform(keys[N, 2], (d,))`` is the ``[N, d]`` stack of each key's
draw.

Every function here is bitwise equal to its jax counterpart; ``gumbel``
and ``normal`` get there by evaluating XLA's own ``log``, ``log1p`` and
``erf_inv`` expansions (:mod:`.xla_math`) rather than torch's libm.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device

from . import xla_math

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform", "gumbel",
           "exponential", "normal", "randint", "threefry2x32", "hash_pairs",
           "uniform_from_bits", "gumbel_from_bits"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 block cipher (20 rounds), elementwise on int64
    tensors of uint32 values; ``k1``/``k2`` broadcast against ``x1``/``x2``.
    Mirrors ``jax._src.prng._threefry2x32_lowering`` step for step."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: ``[0, seed mod 2^32]``,
    on ``device`` (the card unless told otherwise)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def _key_halves(key: torch.Tensor, ndim: int):
    """Key lanes shaped to broadcast against an ``ndim``-dim count grid."""
    lead = key.shape[:-1]
    view = (*lead, *([1] * ndim))
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def hash_pairs(key: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """Both threefry output lanes of ``key`` (leading dims act as a batch
    of keys) over explicit count pairs ``(hi, lo)``: int64 tensors of
    uint32 values, one pair per element.  Every draw of this module and
    the slice draws of :mod:`.streams` hash through here."""
    k1, k2 = _key_halves(key, hi.dim())
    return threefry2x32(k1, k2, hi, lo)


def _hash_counts(key: torch.Tensor, shape):
    """The partitionable layout: element ``i`` of a ``shape``-sized draw
    hashes the pair ``(i >> 32, i & 0xffffffff)``."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    return hash_pairs(key, idx >> 32, idx & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)`` (on the
    ``meta`` device, only the shape)."""
    if key.device.type == "meta":
        return torch.empty((*key.shape[:-1], num, 2), dtype=torch.int64,
                           device="meta")
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` for a uint32 ``data`` value."""
    data = int(data)
    if not 0 <= data <= _M32:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    k1, k2 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k1)
    o1, o2 = threefry2x32(k1, k2, zero, zero + data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), ``shape`` per key."""
    b1, b2 = _hash_counts(key, shape)
    return b1 ^ b2


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    # jax's _uniform for float32 [0, 1): mantissa bits into [1, 2), shift
    # down, clamp (the clamp is load-bearing in jax; replicated verbatim).
    fb = (bits >> 9) | 0x3F800000
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """jax's float32 uniform on ``[minval, maxval)`` from its 32 random
    bits per element."""
    floats = _bits_to_uniform(bits)
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    # jax: max(minval, floats * (maxval - minval) + minval) in float32,
    # which XLA contracts into one fused multiply-add
    return torch.clamp_min(xla_math.fma(floats, span, lo), float(lo))


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax's float32 Gumbel (mode "low") from its 32 random bits per
    element: ``-log(-log(u))`` over ``u`` uniform on ``[tiny, 1)``."""
    tiny = float(np.finfo(np.float32).tiny)
    return -xla_math.log(-xla_math.log(uniform_from_bits(bits, tiny, 1.0)))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in mode "low"."""
    return gumbel_from_bits(random_bits(key, shape))


def exponential(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.exponential(key, shape, float32)``: ``-log1p(-u)``."""
    return -xla_math.log1p(-uniform(key, shape))


# XLA's float32 erf_inv (Giles' single-precision approximation), the
# expansion chlo.erf_inv lowers to.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -xla_math.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, xla_math.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = xla_math.fma(p, w, torch.where(lt, c_lt, c_ge))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (on the ``meta`` device,
    only the shape: a model laid out there draws nothing)."""
    if key.device.type == "meta":
        return torch.empty((*key.shape[:-1], *shape), dtype=torch.float32,
                           device="meta")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _erf_inv(u) * float(np.float32(np.sqrt(2)))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b) mod 2^32`` for uint32 values without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(key: torch.Tensor, shape, minval: int,
            maxval: "int | torch.Tensor") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32 (jax's
    double-width modulus, in the wrapping uint32 arithmetic it uses).

    ``maxval`` may be an int32 tensor instead of an int: its shape is a prefix of the output's leading (key) axes, and each
    entry bounds the draws below it, as a traced bound does under
    ``jax.vmap``.  The draws are the same bits as with that bound given as
    an int."""
    minval = int(minval)
    bounded = isinstance(maxval, torch.Tensor)
    if not bounded:
        maxval = int(maxval)
    if not (-2**31 <= minval < 2**31
            and (bounded or -2**31 <= maxval < 2**31)):
        raise ValueError("randint bounds must fit int32")
    ks = split(key, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    if bounded:
        if maxval.dtype != torch.int32:
            raise TypeError(f"randint maxval must be an int32 tensor, got "
                            f"{maxval.dtype}")
        hi = maxval.to(device=higher.device, dtype=torch.int64)
        hi = hi.reshape(*hi.shape, *([1] * (higher.dim() - hi.dim())))
        span = torch.where(hi <= minval, 1, (hi - minval) & _M32)
        mult = ((((2 ** 16) % span) ** 2) & _M32) % span
        offset = (_mul32(higher % span, mult) + lower % span) & _M32
    else:
        span = 1 if maxval <= minval else (maxval - minval) & _M32
        mult = (2 ** 16) % span
        mult = ((mult * mult) & _M32) % span
        offset = (_mul32(higher % span, torch.full_like(higher, mult))
                  + lower % span) & _M32
    out = (offset % span + minval) & _M32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
