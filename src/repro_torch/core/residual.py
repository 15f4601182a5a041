"""Error-feedback residual state (paper Algo. 1 lines 4/9).

The residual ``e_t^i = (f U - Pi(Theta(f U)))/f`` is client-local state with
the same flat shape as the update vector; in the FL simulator it is an
``[N, d]`` stack.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device

__all__ = ["init_residual", "residual_after_upload"]


def init_residual(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """A zero residual of ``d`` coordinates on ``device`` (the card unless
    told otherwise)."""
    return torch.zeros((d,), dtype=dtype, device=resolve_device(device))


def residual_after_upload(u: torch.Tensor,
                          uploaded_over_f: torch.Tensor) -> torch.Tensor:
    """e = u - (own uploaded contribution)/f.

    ``uploaded_over_f`` is this client's de-quantized uploaded vector
    (zeros at unselected coordinates), i.e. Pi(Theta(f u)) / f.
    """
    return (u - uploaded_over_f).to(u.dtype)
