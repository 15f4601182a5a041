"""Public entry points of the port's kernels, as the round calls them.

The reference's ``kernels/ops.py`` pads every flat vector to a
``(rows, 1024)`` matrix with ``rows % 8 == 0`` — the TPU's VMEM tiling.
The CUDA kernels take flat row-major operands and mask their own ragged
tail, so these wrappers only bring ``f`` to a float32 scalar on the
operands' device (the kernel reads it from device memory, no host sync)
and dispatch.
"""

from __future__ import annotations

import torch

from .gather_quant import gather_quant
from .stoch_quant import stoch_quant

__all__ = ["quantize_flat", "gather_quant_flat"]


def _scalar_f(f, like: torch.Tensor) -> torch.Tensor:
    """``f`` (float or scalar tensor) as a 0-dim float32 tensor on
    ``like``'s device."""
    return torch.as_tensor(f, dtype=torch.float32, device=like.device).reshape(())


def quantize_flat(u: torch.Tensor, uniforms: torch.Tensor, f) -> torch.Tensor:
    """Eq. 1 with scale ``f``: float32 ``[..., L]`` -> int32 ``[..., L]``."""
    return stoch_quant(u, uniforms, _scalar_f(f, u))


def gather_quant_flat(u: torch.Tensor, uniforms: torch.Tensor,
                      sel: torch.Tensor, f):
    """Fused phase-2 client round: ``(u [N, L] or [L], uniforms like u,
    shared sel uint8 [L], f) -> (q_dense int32, residual float32)``."""
    return gather_quant(u, uniforms, sel, _scalar_f(f, u))
