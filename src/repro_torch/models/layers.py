"""Shared building blocks: norms, activations, RoPE, gated MLPs.

Mirrors the reference's ``models/layers.py``.  Parameters live in
``nn.Module``s as ``nn.Parameter``s in the reference's ``(in_dim,
out_dim)`` layout, so ``x @ w`` is the same product; the apply functions
take the plain nested dict of (cast) tensors that
:func:`repro_torch.models.model.cast_params` makes of a module, so they
read ``p["wg"]`` as the reference does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng

__all__ = ["rms_norm", "init_rms", "dense_init", "activation", "rope_freqs",
           "apply_rope", "MLP", "init_mlp", "apply_mlp"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * w.float()).to(dt)


def init_rms(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


def dense_init(key: torch.Tensor, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> nn.Parameter:
    """The reference's ``normal(key, (d_in, d_out)) * scale`` from the same
    threefry draw, on ``key``'s device."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    return nn.Parameter((prng.normal(key, (d_in, d_out)) * scale).to(dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default erf
    # form differs by up to 4.7e-4
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu, "geglu": _gelu,
            "relu": torch.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    e = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
    # float32 pow, correctly rounded (a float64 pow rounded once), as the
    # reference's eager XLA computes it; torch's vectorised pow is an ulp
    # off on one of Qwen3's 64 frequencies.  (Staged under jit, XLA
    # rewrites 1/pow(t, e) as pow(t, -e): see ROADMAP queue C.)
    powed = (np.float64(np.float32(theta)) ** e.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.float32(1.0) / powed).to(device)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, dim, 2) / dim)`` in float32, bitwise equal
    to the reference's eager value (cached per device; do not modify)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return _rope_freqs(int(dim), float(theta), device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated MLP weights: ``wg``, ``wu`` (d, f) and ``wd`` (f, d)."""

    def __init__(self, wg: nn.Parameter, wu: nn.Parameter, wd: nn.Parameter):
        super().__init__()
        self.wg, self.wu, self.wd = wg, wu, wd


def init_mlp(key: torch.Tensor, d: int, f: int, dtype) -> MLP:
    kg, ku, kd = prng.split(key, 3)
    return MLP(dense_init(kg, d, f, dtype), dense_init(ku, d, f, dtype),
               dense_init(kd, f, d, dtype))


def apply_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    fn = activation(act)
    h = fn(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]
