"""Hymba-style hybrid head block (arXiv:2411.13676).

Mirrors the reference's ``models/hybrid.py``.  Attention heads and Mamba
(SSD) heads run in parallel on the same layer input; their outputs are
normalized independently, scaled by learned per-path gains and averaged.
Attention runs sliding-window (hymba-1.5b: 2048, grouped 25 query over 5
KV heads), so above ``DENSE_MAX_SEQ`` the card's kernel (B6) runs it with
the window at the positions ``arange(S)`` the caller declares.  Decode
keeps a (ring) KV cache beside the SSM state.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import prng

from . import attention as attn_mod
from . import ssm as ssm_mod
from .layers import init_rms, rms_norm

__all__ = ["Hybrid", "init_hybrid", "hybrid_forward", "init_hybrid_cache",
           "decode_hybrid"]


class Hybrid(nn.Module):
    """``attn`` (:class:`~.attention.Attention`), ``ssm``
    (:class:`~.ssm.SSM`), ``attn_out_norm``, ``ssm_out_norm`` (d,), and
    the 0-dim gains ``beta1``, ``beta2``."""

    def __init__(self, attn, ssm, attn_out_norm, ssm_out_norm, beta1, beta2):
        super().__init__()
        self.attn, self.ssm = attn, ssm
        self.attn_out_norm, self.ssm_out_norm = attn_out_norm, ssm_out_norm
        self.beta1, self.beta2 = beta1, beta2


def init_hybrid(key: torch.Tensor, cfg) -> Hybrid:
    ka, ks = prng.split(key, 2)
    dt = getattr(torch, cfg.param_dtype)
    dev = key.device

    def one():
        return nn.Parameter(torch.ones((), dtype=dt, device=dev))

    return Hybrid(attn_mod.init_attention(ka, cfg), ssm_mod.init_ssm(ks, cfg),
                  init_rms(cfg.d_model, dt, dev), init_rms(cfg.d_model, dt, dev),
                  one(), one())


def _mix(p: dict, ya: torch.Tensor, ys: torch.Tensor, cfg) -> torch.Tensor:
    ya = rms_norm(ya, p["attn_out_norm"], cfg.rms_eps)
    ys = rms_norm(ys, p["ssm_out_norm"], cfg.rms_eps)
    return 0.5 * (p["beta1"] * ya + p["beta2"] * ys)


def hybrid_forward(p: dict, x: torch.Tensor, cfg, *, positions,
                   arange_positions: bool = False) -> torch.Tensor:
    ya = attn_mod.multihead_attention(p["attn"], x, cfg, positions=positions,
                                      arange_positions=arange_positions)
    ys = ssm_mod.ssd_forward(p["ssm"], x, cfg)
    return _mix(p, ya, ys, cfg)


def init_hybrid_cache(cfg, batch: int, length: int, dtype, device) -> dict:
    return {"attn": attn_mod.init_kv_cache(cfg, batch, length, dtype, device),
            "ssm": ssm_mod.init_ssm_cache(cfg, batch, dtype, device)}


def decode_hybrid(p: dict, x: torch.Tensor, cache: dict, pos, cfg, *, ring: bool):
    ya, cache["attn"] = attn_mod.decode_attention(p["attn"], x, cache["attn"],
                                                  pos, cfg, ring=ring)
    ys, cache["ssm"] = ssm_mod.decode_ssm(p["ssm"], x, cache["ssm"], cfg)
    return _mix(p, ya, ys, cfg), cache
