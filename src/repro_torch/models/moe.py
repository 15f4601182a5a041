"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Mirrors the reference's ``models/moe.py`` (granite-moe-1b: 32 experts
top-8; DeepSeek-V2: 160 routed experts top-6 plus 2 shared).  Dispatch is
slot-looped: the k routing slots are taken one at a time, each scattering
its tokens into an (E, capacity, d) buffer with ``index_add_`` (a dropped
token adds +0 at its expert's slot 0, which changes no value); the experts
run as three batched products over the buffer, and the results are
gathered back slot by slot, weighted by the router probability, in the
compute dtype and in the reference's order.

Routing ties: ``lax.top_k`` puts the lower expert index first, which a
stable descending sort does too (``torch.topk`` does not promise it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng

from .layers import MLP, apply_mlp, dense_init, init_mlp

__all__ = ["MoE", "init_moe", "apply_moe", "MOE_TOKEN_CHUNK"]

MOE_TOKEN_CHUNK = 32_768  # chunked dispatch above this (prefill-scale) count


class MoE(nn.Module):
    """``router`` (d, E), experts ``we_g``/``we_u`` (E, d, fe) and ``we_d``
    (E, fe, d), and with shared experts ``shared`` (a gated MLP of width
    ``fe · n_shared``)."""

    def __init__(self, router, we_g, we_u, we_d, shared: MLP | None = None):
        super().__init__()
        self.router, self.we_g, self.we_u, self.we_d = router, we_g, we_u, we_d
        if shared is not None:
            self.shared = shared


def init_moe(key: torch.Tensor, cfg) -> MoE:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    ks = prng.split(key, 5)
    dt = getattr(torch, cfg.param_dtype)

    def experts(k, shape, fan_in):
        return nn.Parameter((prng.normal(k, shape) / fan_in ** 0.5).to(dt))

    shared = (init_mlp(ks[4], d, fe * cfg.n_shared_experts, dt)
              if cfg.n_shared_experts > 0 else None)
    return MoE(dense_init(ks[0], d, e, dt), experts(ks[1], (e, d, fe), d),
               experts(ks[2], (e, d, fe), d), experts(ks[3], (e, fe, d), fe),
               shared)


def apply_moe(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    Above ``MOE_TOKEN_CHUNK`` tokens, when the count is a multiple of it,
    dispatch runs over sequential token chunks (the reference's
    ``lax.map``) and the aux values are averaged."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    if t > MOE_TOKEN_CHUNK and t % MOE_TOKEN_CHUNK == 0:
        ys, auxes = zip(*(_moe_core(p, c, cfg)
                          for c in xt.split(MOE_TOKEN_CHUNK)))
        return torch.cat(ys).reshape(b, s, d).to(x.dtype), torch.stack(auxes).mean()
    y, aux = _moe_core(p, xt, cfg)
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_core(p: dict, xt: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.moe_top_k

    logits = (xt @ p["router"]).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]                 # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # exact (dropless) capacity for small token counts (decode steps, smoke
    # tests); factor-based capacity for prefill shapes
    capacity = t if t <= 256 else max(1, int(cfg.capacity_factor * t * k / e))

    buf = torch.zeros((e * capacity, d), dtype=xt.dtype, device=xt.device)
    tokens_per_e = torch.zeros((e,), dtype=torch.float32, device=xt.device)
    offset = torch.zeros((e,), dtype=torch.int64, device=xt.device)
    experts = torch.arange(e, device=xt.device)[:, None]
    slot_meta = []
    for j in range(k):                       # k is small (6-8)
        ej = top_e[:, j]                                      # (T,)
        # the one-hot laid out (E, T), so the running count of each
        # expert's earlier tokens is a scan along the inner axis (exact
        # integers, as the reference's (T, E) cumsum over tokens)
        oh = (ej[None, :] == experts).to(torch.int32)         # (E, T)
        within = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
        pos = within.gather(0, ej[None, :])[0] + offset[ej]
        keep = pos < capacity
        pos_safe = torch.where(keep, pos, 0)
        row = ej * capacity + pos_safe
        buf.index_add_(0, row, torch.where(keep[:, None], xt, 0).to(xt.dtype))
        counts = oh.sum(dim=1)
        offset = offset + counts
        tokens_per_e = tokens_per_e + counts.float()
        slot_meta.append((row, keep))

    # load-balance aux loss (Switch-style)
    aux = e * torch.sum((tokens_per_e / (t * k)) * probs.mean(dim=0))

    # expert compute: batched SwiGLU over the (E, C, d) buffer
    buf = buf.view(e, capacity, d)
    h = F.silu(torch.bmm(buf, p["we_g"])) * torch.bmm(buf, p["we_u"])
    y_buf = torch.bmm(h, p["we_d"]).view(e * capacity, d)     # (E·C, d)

    # combine: per-slot gather weighted by the router probability, in the
    # compute dtype (as the reference: an f32 accumulator at (T, d) scale
    # costs gigabytes)
    y = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    for j, (row, keep) in enumerate(slot_meta):
        w = (top_p[:, j] * keep).to(xt.dtype)[:, None]
        y = y + y_buf[row] * w

    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt, cfg.act)
    return y, aux
