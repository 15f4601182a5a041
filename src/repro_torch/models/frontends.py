"""Modality frontend stubs.

Mirrors the reference's ``models/frontends.py``: for whisper-tiny the
mel-spectrogram and two-convolution feature extractor are stubbed, and the
encoder takes precomputed frame embeddings (B, source_len = 1500, d_model),
what the convolutions would emit for a 30 s clip at 50 Hz.  chameleon-34b's
images arrive as VQ tokens in its vocabulary, so it needs no extra input.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import prng

__all__ = ["audio_frames_spec", "synth_audio_frames"]


def audio_frames_spec(batch: int, source_len: int, d_model: int,
                      dtype=torch.float32) -> torch.Tensor:
    """The frames' shape and dtype as a tensor on the ``meta`` device (no
    storage), where the reference returns a ``jax.ShapeDtypeStruct``."""
    return torch.empty((batch, source_len, d_model), dtype=dtype, device="meta")


def synth_audio_frames(key: torch.Tensor, batch: int, source_len: int,
                       d_model: int, device=None) -> torch.Tensor:
    """Synthetic stand-in frame embeddings, ``normal(key, shape) * 0.02``,
    the reference's draw from the same key (on ``device``, the key's
    device unless given)."""
    if device is not None:
        key = key.to(resolve_device(device))
    return prng.normal(key, (batch, source_len, d_model)) * 0.02
