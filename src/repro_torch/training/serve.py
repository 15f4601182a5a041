"""Serving steps: prefill (full-sequence forward) and single-token decode.

Mirrors the reference's ``training/serve.py`` on one device.  A
``prefill`` shape's step runs ``forward(..., last_only=True)`` and returns
the last position's logits; a ``decode`` shape's step is one token against
a KV cache of :func:`cache_len_for` (a ring buffer for long or windowed
decode).  The reference's mesh, ``param_specs`` and ``cache_specs`` come
with ``models/shardings.py`` (ROADMAP queue A 1, after training on the
zoo).  Both steps run without autograd.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.models import decode_step, forward

__all__ = ["ServeBundle", "cache_len_for", "make_serve_step"]


@dataclass
class ServeBundle:
    step: callable
    ring: bool
    cache_len: int


def cache_len_for(cfg, shape) -> tuple[int, bool]:
    """(cache length, ring?) for a decode shape."""
    if shape.seq_len > 65536 or (0 < cfg.sliding_window < shape.seq_len):
        window = cfg.long_decode_window if shape.seq_len > 65536 else cfg.sliding_window
        return min(window, shape.seq_len), True
    return shape.seq_len, False


def make_serve_step(cfg, shape, device=None) -> ServeBundle:
    """The serve step of ``shape`` (an :class:`~repro_torch.configs.InputShape`)
    on ``device`` (the card unless told otherwise).

    prefill: ``step(params, {"tokens": (B, S)}) -> logits (B, V)``, with
    ``"frames"`` (B, source_len, d_model) beside the tokens for the
    encoder-decoder; decode: ``step(params, caches, token (B, 1), pos) ->
    (logits, caches)``.  Every input (tokens and frames) is moved to the
    bundle's device.
    """
    device = resolve_device(device)
    if shape.kind == "prefill":
        @torch.no_grad()
        def step(params, batch_d):
            batch_d = {k: torch.as_tensor(v, device=device)     # tokens, frames
                       for k, v in batch_d.items()}
            logits, _ = forward(params, cfg, batch_d, last_only=True)
            return logits[:, -1, :]

        return ServeBundle(step, False, shape.seq_len)

    clen, ring = cache_len_for(cfg, shape)

    @torch.no_grad()
    def step(params, caches, token, pos):
        return decode_step(params, cfg, torch.as_tensor(token, device=device),
                           caches, pos, ring=ring)

    return ServeBundle(step, ring, clen)
