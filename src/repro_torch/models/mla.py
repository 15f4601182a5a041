"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Mirrors the reference's ``models/mla.py``.  KV state is compressed into a
rank-``kv_lora_rank`` latent ``c_kv`` plus a small shared RoPE key
(``qk_rope_dim``); queries go through their own low-rank path.  The decode
cache holds only ``(c_kv, k_rope)``, written in place.

Prefill above ``DENSE_MAX_SEQ`` takes the blockwise branch: on a CUDA
tensor the flash-attention kernel (B6) with q and k ``qk_nope + qk_rope``
wide and v ``v_head_dim`` wide, at the positions ``arange(S)`` the caller
declares (:func:`repro_torch.models.attention.multihead_attention`); on a
CPU tensor the plain ``_blockwise_attention``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import prng

from . import attention as attn_mod
from .attention import (NEG_INF, _blockwise_attention, _dense_attention,
                        _flash_or_raise)
from .layers import apply_rope, dense_init, init_rms, rms_norm

__all__ = ["MLA", "init_mla", "mla_attention", "init_mla_cache", "decode_mla"]


class MLA(nn.Module):
    """``wdkv`` (d, r_kv), ``wkr`` (d, dr), ``wuk`` (r_kv, H·dn), ``wuv``
    (r_kv, H·dv), ``wo`` (H·dv, d), ``kv_norm`` (r_kv,), and the queries'
    ``wdq`` (d, r_q), ``wuq`` (r_q, H·(dn+dr)), ``q_norm`` (r_q,) when
    ``q_lora_rank > 0``, else ``wq`` (d, H·(dn+dr))."""

    def __init__(self, wdkv, wkr, wuk, wuv, wo, kv_norm, *, wdq=None,
                 wuq=None, q_norm=None, wq=None):
        super().__init__()
        self.wdkv, self.wkr, self.wuk, self.wuv = wdkv, wkr, wuk, wuv
        self.wo, self.kv_norm = wo, kv_norm
        if wq is None:
            self.wdq, self.wuq, self.q_norm = wdq, wuq, q_norm
        else:
            self.wq = wq


def init_mla(key: torch.Tensor, cfg) -> MLA:
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ks = prng.split(key, 8)
    dt = getattr(torch, cfg.param_dtype)
    if r_q > 0:
        q = dict(wdq=dense_init(ks[5], d, r_q, dt),
                 wuq=dense_init(ks[6], r_q, h * (dn + dr), dt),
                 q_norm=init_rms(r_q, dt, key.device))
    else:
        q = dict(wq=dense_init(ks[7], d, h * (dn + dr), dt))
    return MLA(dense_init(ks[0], d, r_kv, dt), dense_init(ks[1], d, dr, dt),
               dense_init(ks[2], r_kv, h * dn, dt),
               dense_init(ks[3], r_kv, h * dv, dt),
               dense_init(ks[4], h * dv, d, dt), init_rms(r_kv, dt, key.device),
               **q)


def _queries(p, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if "wdq" in p:
        q = rms_norm(x @ p["wdq"], p["q_norm"], cfg.rms_eps) @ p["wuq"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _keys_values(p, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    c_kv = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.rms_eps)
    k_rope = apply_rope((x @ p["wkr"]).reshape(b, s, 1, dr), positions,
                        cfg.rope_theta)
    k_nope = (c_kv @ p["wuk"]).reshape(b, s, h, dn)
    v = (c_kv @ p["wuv"]).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    return k, v, c_kv, k_rope


def mla_attention(p: dict, x: torch.Tensor, cfg, *, positions,
                  arange_positions: bool = False) -> torch.Tensor:
    """Full-sequence MLA (prefill).  ``arange_positions`` declares
    ``positions`` to be ``arange(S)``, which the card's kernel needs above
    ``DENSE_MAX_SEQ``."""
    b, s, _ = x.shape
    h, dv = cfg.n_heads, cfg.v_head_dim
    q = _queries(p, x, cfg, positions)
    k, v, _, _ = _keys_values(p, x, cfg, positions)
    scale = 1.0 / math.sqrt(cfg.qk_dim)
    if s <= attn_mod.DENSE_MAX_SEQ:
        out = _dense_attention(q, k, v, positions, positions, True,
                               cfg.sliding_window, scale)
    elif x.device.type == "cuda":
        out = _flash_or_raise(q, k, v, True, cfg.sliding_window,
                              arange_positions, cross=False)
    else:
        out = _blockwise_attention(q, k, v, positions, positions, True,
                                   cfg.sliding_window, scale,
                                   cfg.attn_q_block, cfg.attn_kv_block)
    return out.reshape(b, s, h * dv).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# Decode with the compressed latent cache
# ---------------------------------------------------------------------------

def init_mla_cache(cfg, batch: int, length: int, dtype, device) -> dict:
    return {"c_kv": torch.zeros((batch, length, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, length, cfg.qk_rope_dim), dtype=dtype,
                                  device=device)}


def decode_mla(p: dict, x: torch.Tensor, cache: dict, pos, cfg, *,
               ring: bool = False, absorbed: bool = False):
    """One-token MLA decode; ``(c_kv, k_rope)`` are written into ``cache``
    in place.  ``absorbed=True`` keeps attention in the latent space (W_uk
    folded into the query, W_uv into the output), the paper's matrix
    absorption, which DeepSeek-V2's config selects."""
    b, _, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    cc, cr = cache["c_kv"], cache["k_rope"]
    t = cc.shape[1]
    posb = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)
    posv = posb[:, None]
    q = _queries(p, x, cfg, posv)                          # (B,1,H,dn+dr)
    c_kv = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.rms_eps)   # (B,1,r)
    k_rope = apply_rope((x @ p["wkr"]).reshape(b, 1, 1, dr), posv,
                        cfg.rope_theta).reshape(b, 1, dr)
    slot = posb % t if ring else torch.clamp(posb, max=t - 1)
    rows = torch.arange(b, device=x.device) * t + slot
    cc.view(b * t, r_kv).index_copy_(0, rows, c_kv[:, 0].to(cc.dtype))
    cr.view(b * t, dr).index_copy_(0, rows, k_rope[:, 0].to(cr.dtype))
    slots = torch.arange(t, device=x.device)[None, :]
    if ring:
        kpos = posb[:, None] - ((posb[:, None] - slots) % t)
    else:
        kpos = slots.expand(b, t)
    valid = (kpos <= posb[:, None]) & (kpos >= 0)
    scale = 1.0 / math.sqrt(cfg.qk_dim)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    if absorbed:
        # fold W_uk into q: q_lat (B,1,H,r) = q_nope @ W_uk^T (per head)
        wuk = p["wuk"].reshape(r_kv, h, dn)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wuk.float())
        sc = torch.einsum("bqhr,btr->bhqt", q_lat, cc.float())
        sc = sc + torch.einsum("bqhd,btd->bhqt", q_rope.float(), cr.float())
        sc = torch.where(valid[:, None, None, :], sc * scale, NEG_INF)
        w = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("bhqt,btr->bqhr", w, cc.float())  # latent ctx
        wuv = p["wuv"].reshape(r_kv, h, dv)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, wuv.float())
    else:
        k_nope = (cc @ p["wuk"]).reshape(b, t, h, dn)
        v = (cc @ p["wuv"]).reshape(b, t, h, dv)
        k = torch.cat([k_nope, cr[:, :, None, :].expand(b, t, h, dr)], dim=-1)
        sc = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale
        sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
        w = torch.softmax(sc, dim=-1)
        out = torch.einsum("bhqt,bthd->bqhd", w, v.float())
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return out @ p["wo"], {"c_kv": cc, "k_rope": cr}
