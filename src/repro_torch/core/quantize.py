"""Unbiased stochastic integer quantization (paper Eq. 1).

A model update ``U_l`` is scaled by ``f = (2^{b-1} - N)/(N m)`` and rounded to
an integer stochastically:

    theta(x) = floor(x)  with prob  ceil(x) - x
             = ceil(x)   with prob  x - floor(x)

so that E[theta(x)] = x.  The switch only ever sees int32 values;
de-quantization by 1/(N f) happens on the clients (Algo. 1 line 12).

``f`` is a float32 tensor on the operands' device: a division by a Python
float would run as a multiplication by its reciprocal on the card and
round differently from the reference's IEEE division.
"""

from __future__ import annotations

import torch

from .powerlaw import scale_factor

__all__ = ["scale_factor", "stochastic_round", "quantize", "dequantize"]


def stochastic_round(x: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding to the nearest integers (Eq. 1).

    ``uniforms`` are iid U[0,1) of the same shape as ``x``.  Returns int32.
    """
    lo = torch.floor(x)
    frac = x - lo  # in [0, 1): prob of rounding up
    up = (uniforms < frac).to(x.dtype)
    return (lo + up).to(torch.int32)


def quantize(u: torch.Tensor, f: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """q = theta(f * u) as int32."""
    return stochastic_round(u.to(torch.float32) * f, uniforms)


def dequantize(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) / f
