"""FediAC in PyTorch on an NVIDIA H100: the port of :mod:`repro` (JAX/TPU).

The layout mirrors ``src/repro/`` module for module, so each module here
has its reference counterpart at the same path.  The port imports torch
and numpy only; the hand-written CUDA kernels live in
:mod:`repro_torch.kernels` and are built from ``kernels/csrc`` at first
use.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card present they raise instead of falling back.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]

# float32 matmuls and convolutions stay full float32 on the card (the
# reference's local SGD is float32); TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    ``None`` means the card and raises when there is none; only an explicit
    ``"cpu"`` runs on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on a CUDA device and none is "
                               "available; pass device='cpu' to run on the "
                               "host explicitly")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
