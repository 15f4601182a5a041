"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060).

Mirrors the reference's ``models/ssm.py``.  Chunked SSD forward: within
chunks of Q tokens the recurrence is expanded into a masked
(semiseparable) attention-like product; across chunks the (B, H, P, N)
float32 state is carried.  The reference's ``lax.scan`` over chunks does
both per step; here the intra-chunk products, which need no state, run
for all chunks at once as batched products, and only the state recurrence
``S_c = exp(cum_last) S_{c-1} + ΔS_c`` walks the chunks in a Python loop
(a few elementwise ops per chunk).  Every value is computed by the same
expression as the reference's step, so the split changes no rounding but
the order of float32 sums inside the products.

Decode is the exact recurrence ``S <- a S + dt (B ⊗ x)``,
``y = C·S + D x``, O(1) per token; its state and convolution history are
written into the cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng

from .layers import dense_init, init_rms, rms_norm

__all__ = ["SSM", "init_ssm", "ssd_forward", "init_ssm_cache", "decode_ssm",
           "softplus"]


class SSM(nn.Module):
    """The projections ``w_x``, ``w_z`` (d, d_inner), ``w_B``, ``w_C`` (d,
    G·N), ``w_dt`` (d, H), the depthwise ``conv`` (W, d_inner + 2·G·N),
    ``A_log``, ``D``, ``dt_bias`` (H,), ``norm`` (d_inner,) and
    ``out_proj`` (d_inner, d)."""

    def __init__(self, w_x, w_z, w_B, w_C, w_dt, conv, A_log, D, dt_bias,
                 norm, out_proj):
        super().__init__()
        self.w_x, self.w_z, self.w_B, self.w_C, self.w_dt = w_x, w_z, w_B, w_C, w_dt
        self.conv, self.A_log, self.D, self.dt_bias = conv, A_log, D, dt_bias
        self.norm, self.out_proj = norm, out_proj


def init_ssm(key: torch.Tensor, cfg) -> SSM:
    d, h, p_dim = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim
    din = h * p_dim
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    ks = prng.split(key, 8)
    dt = getattr(torch, cfg.param_dtype)
    dev = key.device

    def const(value):
        return nn.Parameter(torch.full((h,), value, dtype=dt, device=dev))

    conv = nn.Parameter((prng.normal(ks[5], (w, din + 2 * g * n))
                         / w ** 0.5).to(dt))
    return SSM(dense_init(ks[0], d, din, dt), dense_init(ks[1], d, din, dt),
               dense_init(ks[2], d, g * n, dt), dense_init(ks[3], d, g * n, dt),
               dense_init(ks[4], d, h, dt), conv,
               const(0.0),          # A_log: A = -exp(A_log) = -1 at init
               const(1.0), const(0.0), init_rms(din, dt, dev),
               dense_init(ks[6], din, d, dt))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = ``max(x, 0) +
    log1p(exp(-|x|))``, without torch's linear threshold."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C), w: (W,C) depthwise causal conv + SiLU, the taps added in
    the reference's order."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out)


def _project(p: dict, x: torch.Tensor, cfg):
    """Shared projections for both prefill and decode."""
    xin = x @ p["w_x"]
    z = x @ p["w_z"]
    braw = x @ p["w_B"]
    craw = x @ p["w_C"]
    dt_raw = x @ p["w_dt"]
    conv_in = torch.cat([xin, braw, craw], dim=-1)
    return conv_in, z, dt_raw


def _split_conv(conv_out: torch.Tensor, cfg):
    din = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return (conv_out[..., :din], conv_out[..., din:din + gn],
            conv_out[..., din + gn:])


def ssd_forward(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); S must be a multiple of ssm_chunk."""
    b, s, d = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n, q = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of ssm_chunk {q}")
    nc = s // q

    conv_in, z, dt_raw = _project(p, x, cfg)
    xin, braw, craw = _split_conv(_causal_conv(conv_in, p["conv"]), cfg)

    # full-sequence tensors stay in the compute dtype; state math in f32
    wdt = x.dtype
    xh = xin.reshape(b, s, h, pd)
    bh = braw.reshape(b, s, g, n).repeat_interleave(h // g, dim=2)
    ch = craw.reshape(b, s, g, n).repeat_interleave(h // g, dim=2)
    dt = softplus(dt_raw.float() + p["dt_bias"].float())             # (B,S,H)
    a_log = dt * (-torch.exp(p["A_log"].float()))                    # <= 0

    # chunk views: (B, nc, Q, ...)
    xq, bq, cq, dtq, alq = (t.reshape(b, nc, q, *t.shape[2:])
                            for t in (xh, bh, ch, dt, a_log))
    cum = torch.cumsum(alq, dim=2)                                   # (B,nc,Q,H)
    # intra-chunk: y[t] = sum_{j<=t} (C_t·B_j) exp(cum_t - cum_j) dt_j x_j,
    # the (Q, Q) tiles in the compute dtype, y_intra summed in float32
    # (bf16 x bf16 products are exact in float32)
    cb = torch.einsum("bcthn,bcjhn->bchtj", cq, bq)                  # wdt
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (B,nc,t,j,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(seg), 0.0)
    m = cb * (L.permute(0, 1, 4, 2, 3)
              * dtq[:, :, None, :, :].permute(0, 1, 4, 2, 3)).to(wdt)
    y = torch.einsum("bchtj,bcjhp->bcthp", m.float(), xq.float())
    del cb, seg, L, m
    # the state: S_c = exp(cum_last) S_{c-1} + sum_j exp(cum_last - cum_j)
    # dt_j B_j x_j^T, and y[t] += exp(cum_t) C_t · S_{c-1}
    decay = torch.exp(cum[:, :, -1:, :] - cum) * dtq                 # (B,nc,Q,H)
    ds = torch.einsum("bcjhn,bcjhp,bcjh->bchpn", bq.float(), xq.float(), decay)
    last = torch.exp(cum[:, :, -1, :])[..., None, None]              # (B,nc,H,1,1)
    state = torch.zeros((b, h, pd, n), dtype=torch.float32, device=x.device)
    prev = torch.empty((b, nc, h, pd, n), dtype=torch.float32, device=x.device)
    for c in range(nc):
        prev[:, c] = state
        state = last[:, c] * state + ds[:, c]
    y = y + torch.einsum("bcthn,bchpn->bcthp", cq.float(), prev) \
        * torch.exp(cum)[..., None]
    y = y.to(wdt).reshape(b, s, h, pd)
    y = y + (p["D"].to(wdt)[None, None, :, None] * xh)
    y = y.reshape(b, s, h * pd)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.rms_eps)
    return y.to(wdt) @ p["out_proj"]


# ---------------------------------------------------------------------------
# Decode: exact recurrence, O(1) per token
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, dtype, device) -> dict:
    h, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    chans = cfg.d_inner + 2 * g * n
    return {"state": torch.zeros((batch, h, pd, n), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, chans), dtype=dtype,
                                device=device)}


def decode_ssm(p: dict, x: torch.Tensor, cache: dict, cfg):
    """x: (B,1,D) -> (out (B,1,D), cache); the cache's state and
    convolution history are updated in place."""
    b = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_in, z, dt_raw = _project(p, x, cfg)                  # (B,1,C)
    hist = torch.cat([cache["conv"], conv_in.to(cache["conv"].dtype)], dim=1)
    conv_out = F.silu((hist * p["conv"][None]).sum(dim=1, keepdim=True))
    xin, braw, craw = _split_conv(conv_out, cfg)

    xh = xin.reshape(b, h, pd).float()
    bh = braw.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
    ch = craw.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    a = torch.exp(dt * (-torch.exp(p["A_log"].float())))     # (B,H)

    state = cache["state"] * a[:, :, None, None] + \
        torch.einsum("bhn,bhp,bh->bhpn", bh, xh, dt)
    y = torch.einsum("bhn,bhpn->bhp", ch, state) + \
        p["D"].float()[None, :, None] * xh
    y = y.reshape(b, 1, h * pd)
    y = rms_norm(y * F.silu(z.float()), p["norm"], cfg.rms_eps)
    cache["state"].copy_(state)
    cache["conv"].copy_(hist[:, 1:, :])
    return y.to(x.dtype) @ p["out_proj"], cache
