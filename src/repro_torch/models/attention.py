"""Attention: GQA/MQA with RoPE, optional qk-norm, sliding window, and a
memory-bounded blockwise (online-softmax) path for long sequences.

Mirrors the reference's ``models/attention.py``.  Sequences longer than
``DENSE_MAX_SEQ`` take the blockwise branch: on a CUDA tensor it launches
the hand-written flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`, which
computes what the reference's Pallas kernel computes, at positions
``arange``: callers declare theirs, see :func:`multihead_attention`), on a
CPU tensor it runs the plain :func:`_blockwise_attention` below, the
reference's two-level online-softmax scan as Python loops.  The kernel
picks its own tiles; ``attn_q_block`` / ``attn_kv_block`` are the plain
path's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.kernels.flash_attention import flash_attention

from .layers import apply_rope, dense_init, init_rms, rms_norm

__all__ = ["Attention", "init_attention", "multihead_attention",
           "init_kv_cache", "decode_attention"]

NEG_INF = -1e30
DENSE_MAX_SEQ = 2048       # below this, materialize the full score matrix
Q_BLOCK = 2048
KV_BLOCK = 1024


class Attention(nn.Module):
    """Projections ``wq`` (d, H·dh), ``wk``/``wv`` (d, Hk·dh), ``wo``
    (H·dh, d), and with qk-norm ``q_norm``/``k_norm`` (dh,)."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        if q_norm is not None:
            self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(key: torch.Tensor, cfg) -> Attention:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = prng.split(key, 4)
    dt = getattr(torch, cfg.param_dtype)
    norms = ((init_rms(dh, dt, key.device), init_rms(dh, dt, key.device))
             if cfg.qk_norm else ())
    return Attention(dense_init(ks[0], d, h * dh, dt),
                     dense_init(ks[1], d, hk * dh, dt),
                     dense_init(ks[2], d, hk * dh, dt),
                     dense_init(ks[3], h * dh, d, dt), *norms)


def _mask(qpos, kpos, causal: bool, window: int):
    """(S,), (T,) position vectors -> (S, T) boolean visibility mask."""
    ok = kpos[None, :] >= 0          # negative kpos marks padded KV slots
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def _additive_mask(qpos, kpos, causal: bool, window: int):
    """Additive float32 (S, T) mask: 0 where visible, NEG_INF where masked."""
    ok = _mask(qpos, kpos, causal, window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _dense_attention(q, k, v, qpos, kpos, causal, window, scale):
    """q: (B,S,H,D); k,v: (B,T,Hk,D). Full score matrix, grouped-query form
    (KV heads are never materialized at the full query-head count)."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    dv = v.shape[-1]
    qg = q.reshape(b, s, hk, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    scores = scores + _additive_mask(qpos, kpos, causal, window)[None, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, dv)


def _blockwise_attention(q, k, v, qpos, kpos, causal, window, scale,
                         q_block=None, kv_block=None):
    """Online-softmax two-level loop; O(S·KV_BLOCK) live memory per q block.

    Sliding-window attention runs *banded*: each query block only visits
    the KV blocks inside [q_start - window, q_end), so compute scales with
    the window.  Probability tiles are cast to v's dtype for the p·v
    product, which accumulates in float32 (bf16 x bf16 products are exact
    in float32, so casting both operands up gives the reference's
    ``preferred_element_type=float32``).
    """
    b, s, h, dh = q.shape
    t = k.shape[1]
    hk = k.shape[2]
    dv = v.shape[-1]           # may differ from dh (MLA: qk 192 vs v 128)
    g = h // hk
    qb = min(q_block or Q_BLOCK, s)
    kb = min(kv_block or KV_BLOCK, t)
    if s % qb:
        raise ValueError(f"sequence {s} is not a multiple of the q block {qb}")
    if t % kb:  # pad KV (cross-attention sources, e.g. 1500 audio frames)
        pad = kb - t % kb
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
        t += pad
    nq = s // qb

    # banded mode: fixed span of ceil((window+qb)/kb) KV blocks per q block
    banded = causal and window > 0 and (window + qb) < t
    span = -(-(window + qb) // kb) * kb if banded else t
    nk = span // kb

    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    for iq in range(nq):
        q0 = iq * qb
        qg = q[:, q0:q0 + qb].float().reshape(b, qb, hk, g, dh)
        qp = qpos[q0:q0 + qb]
        start = min(max(q0 + qb - span, 0), t - span) if banded else 0
        m = torch.full((b, hk, g, qb), NEG_INF, device=q.device)
        l = torch.zeros((b, hk, g, qb), device=q.device)
        acc = torch.zeros((b, hk, g, qb, dv), device=q.device)
        for ik in range(nk):
            k0 = start + ik * kb
            kblk, vblk = k[:, k0:k0 + kb], v[:, k0:k0 + kb]
            sc = torch.einsum("bqkgd,bckd->bkgqc", qg, kblk.float()) * scale
            sc = sc + _additive_mask(qp, kpos[k0:k0 + kb], causal,
                                     window)[None, None, None]
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + qb] = o.permute(0, 3, 1, 2, 4).reshape(
            b, qb, h, dv).to(q.dtype)
    return out


def _flash_or_raise(q, k, v, causal: bool, window: int, arange_positions: bool,
                    *, cross: bool) -> torch.Tensor:
    """The card's blockwise branch: B6, whose mask reads the positions
    ``arange(S)`` / ``arange(T)``.  It runs where those are the positions
    (declared by the caller) or where the mask reads no position at all:
    non-causal, unwindowed attention masks nothing but key validity, and B6
    at a ragged T computes exactly the reference's padded blockwise result
    (cross-attention over the encoder's frames).  Anything else raises."""
    positions_free = not causal and window == 0
    if cross and not positions_free:
        raise NotImplementedError(
            "cross-attention on the card above DENSE_MAX_SEQ runs B6 only "
            "without a causal mask or a window (ROADMAP queue A: key "
            "positions for B6)")
    if not (arange_positions or positions_free):
        raise NotImplementedError(
            "flash_attention masks by positions arange(S) / arange(T) "
            "only; attention over other positions above DENSE_MAX_SEQ "
            "on the card needs the kernel to take key positions "
            "(ROADMAP queue A11)")
    return flash_attention(q, k, v, causal=causal, window=window)


def multihead_attention(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                        kv_x: torch.Tensor | None = None, causal: bool = True,
                        kv_positions: torch.Tensor | None = None,
                        arange_positions: bool = False) -> torch.Tensor:
    """Self- (kv_x=None) or cross-attention over full sequences (prefill).

    On the card the blockwise branch's kernel masks by query and key
    positions ``arange(S)`` / ``arange(T)``, as the reference's Pallas
    kernel does.  So it runs only for a caller that declares its
    ``positions`` (and ``kv_positions``) to be those with
    ``arange_positions=True``, as ``forward`` does for self-attention, or
    for a mask that reads no position (non-causal, no window: the
    encoder's self-attention and the decoder's cross-attention); any
    other call on the card above ``DENSE_MAX_SEQ`` raises
    (:func:`_flash_or_raise`).  The flag is taken on trust: the positions
    are never read back from the card.  The dense branch and the CPU's
    blockwise branch mask by the positions given, flag or no flag."""
    b, s, d = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    t = src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (src @ p["wk"]).reshape(b, t, hk, dh)
    v = (src @ p["wv"]).reshape(b, t, hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    kv_positions = positions if kv_positions is None else kv_positions
    if kv_x is None:  # RoPE only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(dh)
    window = cfg.sliding_window
    if s <= DENSE_MAX_SEQ and t <= DENSE_MAX_SEQ:
        out = _dense_attention(q, k, v, positions, kv_positions, causal, window, scale)
    elif x.device.type == "cuda":
        out = _flash_or_raise(q, k, v, causal, window, arange_positions,
                              cross=kv_x is not None)
    else:
        out = _blockwise_attention(q, k, v, positions, kv_positions, causal,
                                   window, scale, cfg.attn_q_block,
                                   cfg.attn_kv_block)
    return out.reshape(b, s, h * dh).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# Decode: one token against a KV cache (optionally a ring buffer for SWA)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, length: int, dtype, device) -> dict:
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, length, hk, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, length, hk, dh), dtype=dtype, device=device)}


def decode_attention(p: dict, x: torch.Tensor, cache: dict, pos, cfg,
                     *, ring: bool = False) -> tuple[torch.Tensor, dict]:
    """x: (B,1,D); cache k/v: (B,T,Hk,D); pos: scalar OR (B,) per-slot
    positions (continuous batching: every sequence may be at a different
    decode offset).

    ring=True treats the cache as a ring buffer of size T (sliding window).
    The new key and value are written into ``cache`` in place
    (``index_copy_``), where the reference returns an updated copy; the
    returned dict holds the same tensors.
    """
    b, _, d = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    t = ck.shape[1]
    posb = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)
    q = (x @ p["wq"]).reshape(b, 1, h, dh)
    k = (x @ p["wk"]).reshape(b, 1, hk, dh)
    v = (x @ p["wv"]).reshape(b, 1, hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, posb[:, None], cfg.rope_theta)
    k = apply_rope(k, posb[:, None], cfg.rope_theta)
    slot = posb % t if ring else torch.clamp(posb, max=t - 1)      # (B,)
    rows = torch.arange(b, device=x.device) * t + slot
    ck.view(b * t, hk, dh).index_copy_(0, rows, k[:, 0].to(ck.dtype))
    cv.view(b * t, hk, dh).index_copy_(0, rows, v[:, 0].to(cv.dtype))
    # positions held in each cache slot, per batch row: (B, T)
    slots = torch.arange(t, device=x.device)[None, :]
    if ring:
        # slot i currently holds position: the latest p <= pos with p % t == i
        kpos = posb[:, None] - ((posb[:, None] - slots) % t)
    else:
        kpos = slots.expand(b, t)
    valid = (kpos <= posb[:, None]) & (kpos >= 0)
    g = h // hk
    qg = q.reshape(b, hk, g, dh)       # single query token, grouped heads
    sc = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) / math.sqrt(dh)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, cv.float())
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return out @ p["wo"], {"k": ck, "v": cv}
