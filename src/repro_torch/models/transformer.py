"""The model trunk: grouped layer stacks of identical blocks.

Mirrors the reference's ``models/transformer.py`` for every mixer
(``attn``, ``mla``, ``ssm``, ``hybrid``), FFN (``mlp``, ``moe``, none) and
the encoder-decoder's cross-attention.  Where the reference stacks a
group's parameters and ``lax.scan``s over them, the port holds an
``nn.ModuleList`` of blocks and walks it in Python.  As in the
reference, every layer's output goes through ``constrain_residual`` and,
with ``cfg.remat`` while autograd records, each layer body is
checkpointed (:func:`apply_group`).

Caches are stacked over a group's layers on axis 0, as the reference's,
whatever their nesting (attention ``{k, v}``, MLA ``{c_kv, k_rope}``, SSM
``{state, conv}``, hybrid ``{attn, ssm}``, and the block-level
``cross_k``/``cross_v``); decode hands each layer a view of its slice of
every leaf, which the layer updates in place.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core import prng
from repro_torch.core.pytree import tree_map

from . import attention as attn_mod
from . import hybrid as hybrid_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import apply_mlp, init_mlp, init_rms, rms_norm

__all__ = ["GroupSpec", "group_plan", "encoder_plan", "Block", "init_block",
           "apply_block", "init_group", "apply_group", "init_block_cache",
           "decode_block", "decode_group"]


@dataclass(frozen=True)
class GroupSpec:
    mixer: str          # attn | mla | ssm | hybrid
    ffn: str            # mlp | moe | none
    n_layers: int
    causal: bool = True
    cross_attn: bool = False
    d_ff: int = 0       # mlp width for this group


def group_plan(cfg) -> list[GroupSpec]:
    """Decoder-side layer grouping for an ArchConfig."""
    if cfg.arch_type == "ssm":
        return [GroupSpec("ssm", "none" if cfg.d_ff == 0 else "mlp",
                          cfg.n_layers, d_ff=cfg.d_ff)]
    if cfg.arch_type == "hybrid":
        return [GroupSpec("hybrid", "mlp", cfg.n_layers, d_ff=cfg.d_ff)]
    mixer = "mla" if cfg.attn_kind == "mla" else "attn"
    groups: list[GroupSpec] = []
    if cfg.n_experts > 0:
        if cfg.first_dense_layers > 0:
            groups.append(GroupSpec(mixer, "mlp", cfg.first_dense_layers,
                                    d_ff=cfg.d_ff_dense or cfg.d_ff))
        groups.append(GroupSpec(mixer, "moe", cfg.n_layers - cfg.first_dense_layers))
        return groups
    cross = cfg.is_enc_dec
    return [GroupSpec(mixer, "mlp", cfg.n_layers, cross_attn=cross, d_ff=cfg.d_ff)]


def encoder_plan(cfg) -> list[GroupSpec]:
    return [GroupSpec("attn", "mlp", cfg.encoder_layers, causal=False,
                      d_ff=cfg.d_ff)]


# ---------------------------------------------------------------------------
# Single block init/apply
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One block: ``ln1`` and ``mix`` (the group's mixer); with
    cross-attention ``cross`` and ``ln_cross``; with an FFN ``ln2`` and
    ``ffn`` (a gated MLP or an MoE)."""

    def __init__(self, ln1, mix, ln2=None, ffn=None, *, cross=None,
                 ln_cross=None):
        super().__init__()
        self.ln1, self.mix = ln1, mix
        if cross is not None:
            self.cross, self.ln_cross = cross, ln_cross
        if ffn is not None:
            self.ln2, self.ffn = ln2, ffn


_INIT_MIXER = {"attn": attn_mod.init_attention, "mla": mla_mod.init_mla,
               "ssm": ssm_mod.init_ssm, "hybrid": hybrid_mod.init_hybrid}


def init_block(key: torch.Tensor, cfg, spec: GroupSpec) -> Block:
    dt = getattr(torch, cfg.param_dtype)
    dev = key.device
    ks = prng.split(key, 4)
    mix = _INIT_MIXER[spec.mixer](ks[0], cfg)
    cross = {}
    if spec.cross_attn:
        cross = dict(cross=attn_mod.init_attention(ks[2], cfg),
                     ln_cross=init_rms(cfg.d_model, dt, dev))
    ln1 = init_rms(cfg.d_model, dt, dev)
    if spec.ffn == "none":
        return Block(ln1, mix, **cross)
    ffn = (moe_mod.init_moe(ks[1], cfg) if spec.ffn == "moe"
           else init_mlp(ks[1], cfg.d_model, spec.d_ff, dt))
    return Block(ln1, mix, init_rms(cfg.d_model, dt, dev), ffn, **cross)


def apply_block(p: dict, x: torch.Tensor, cfg, spec: GroupSpec, *, positions,
                arange_positions: bool = False, enc_out=None,
                enc_positions=None):
    """Full-sequence block (prefill).  Returns (x, aux_loss), the aux loss
    the MoE FFN's (0 otherwise).  ``arange_positions`` declares
    ``positions`` to be ``arange(S)`` for the self-attention mixers
    (:func:`~repro_torch.models.attention.multihead_attention`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if spec.mixer == "attn":
        mix = attn_mod.multihead_attention(p["mix"], h, cfg, positions=positions,
                                           causal=spec.causal,
                                           arange_positions=arange_positions)
    elif spec.mixer == "mla":
        mix = mla_mod.mla_attention(p["mix"], h, cfg, positions=positions,
                                    arange_positions=arange_positions)
    elif spec.mixer == "ssm":
        mix = ssm_mod.ssd_forward(p["mix"], h, cfg)
    else:
        mix = hybrid_mod.hybrid_forward(p["mix"], h, cfg, positions=positions,
                                        arange_positions=arange_positions)
    x = x + mix
    if spec.cross_attn:
        hc = rms_norm(x, p["ln_cross"], cfg.rms_eps)
        x = x + attn_mod.multihead_attention(
            p["cross"], hc, cfg, positions=positions, kv_x=enc_out,
            causal=False, kv_positions=enc_positions)
    if spec.ffn != "none":
        h2 = rms_norm(x, p["ln2"], cfg.rms_eps)
        if spec.ffn == "moe":
            y, aux_l = moe_mod.apply_moe(p["ffn"], h2, cfg)
            aux = aux + aux_l
        else:
            y = apply_mlp(p["ffn"], h2, cfg.act)
        x = x + y
    return x, aux


# ---------------------------------------------------------------------------
# Grouped stacks
# ---------------------------------------------------------------------------

def init_group(key: torch.Tensor, cfg, spec: GroupSpec) -> nn.ModuleList:
    """``spec.n_layers`` blocks from ``split(key, n_layers)``, the keys the
    reference's ``vmap`` over stacked layers uses."""
    keys = prng.split(key, spec.n_layers)
    return nn.ModuleList(init_block(keys[i], cfg, spec)
                         for i in range(spec.n_layers))


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dimensions (``aten.mm``: every
    ``x @ w``), recompute the rest (a ``bmm`` has a batch dimension)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg) -> dict:
    """``torch.utils.checkpoint.checkpoint`` arguments for ``cfg``'s remat
    policy: ``"full"`` keeps each layer's input only; ``"dots"`` also keeps
    its matmul outputs (selective checkpointing)."""
    if cfg.remat_policy == "dots":
        return dict(use_reentrant=False, context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots))
    return dict(use_reentrant=False)


def apply_group(layers: list, x: torch.Tensor, cfg, spec: GroupSpec, *,
                positions, arange_positions: bool = False, enc_out=None,
                enc_positions=None):
    """The group's blocks in order, each output through
    ``constrain_residual``.  Returns (x, aux summed over layers from 0, in
    layer order, as the reference's scan carry).

    With ``cfg.remat`` (while autograd records) each layer body runs under
    ``torch.utils.checkpoint.checkpoint``, as the reference's scan body
    runs under ``jax.checkpoint``: the backward recomputes the layer from
    its stored input.  The recomputation gives the same values."""
    from .shardings import constrain_residual

    def body(layer_p, xc):
        xc, aux_l = apply_block(layer_p, xc, cfg, spec, positions=positions,
                                arange_positions=arange_positions,
                                enc_out=enc_out, enc_positions=enc_positions)
        return constrain_residual(xc), aux_l

    if cfg.remat and torch.is_grad_enabled():
        kw = _remat(cfg)
        run = lambda layer_p, xc: ckpt.checkpoint(body, layer_p, xc, **kw)
    else:
        run = body
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer_p in layers:
        x, aux_l = run(layer_p, x)
        aux = aux + aux_l
    return x, aux


# ---------------------------------------------------------------------------
# Decode blocks (single token, cached)
# ---------------------------------------------------------------------------

def _one_block_cache(cfg, spec: GroupSpec, batch: int, length: int, dtype,
                     device) -> dict:
    c: dict = {}
    if spec.mixer == "attn":
        c["mix"] = attn_mod.init_kv_cache(cfg, batch, length, dtype, device)
    elif spec.mixer == "mla":
        c["mix"] = mla_mod.init_mla_cache(cfg, batch, length, dtype, device)
    elif spec.mixer == "ssm":
        c["mix"] = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    else:
        c["mix"] = hybrid_mod.init_hybrid_cache(cfg, batch, length, dtype, device)
    if spec.cross_attn:
        # the encoder's cross K/V (the reference zeroes them and nothing
        # fills them: see decode_block)
        shape = (batch, cfg.source_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_block_cache(cfg, spec: GroupSpec, batch: int, length: int, dtype,
                     device, n_layers: int) -> dict:
    """A group's caches, every leaf stacked over its layers on axis 0 as
    in the reference (each leaf's dtype the one the reference gives it:
    the SSM state stays float32), allocated once (no per-layer copies to
    stack: at a 32k cache they are as large as the result)."""
    one = _one_block_cache(cfg, spec, batch, length, dtype, "meta")
    return tree_map(lambda c: torch.zeros((n_layers, *c.shape), dtype=c.dtype,
                                          device=device), one)


def decode_block(p: dict, x: torch.Tensor, cache: dict, pos, cfg,
                 spec: GroupSpec, *, ring: bool):
    """One token through one block; ``cache`` (this layer's views) is
    updated in place and returned."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if spec.mixer == "attn":
        mix, cache["mix"] = attn_mod.decode_attention(p["mix"], h, cache["mix"],
                                                      pos, cfg, ring=ring)
    elif spec.mixer == "mla":
        mix, cache["mix"] = mla_mod.decode_mla(p["mix"], h, cache["mix"], pos,
                                               cfg, ring=ring,
                                               absorbed=cfg.mla_absorbed)
    elif spec.mixer == "ssm":
        mix, cache["mix"] = ssm_mod.decode_ssm(p["mix"], h, cache["mix"], cfg)
    else:
        mix, cache["mix"] = hybrid_mod.decode_hybrid(p["mix"], h, cache["mix"],
                                                     pos, cfg, ring=ring)
    x = x + mix
    if spec.cross_attn:
        hc = rms_norm(x, p["ln_cross"], cfg.rms_eps)
        x = x + _cross_decode(p["cross"], hc, cache["cross_k"], cache["cross_v"],
                              cfg)
    if spec.ffn != "none":
        h2 = rms_norm(x, p["ln2"], cfg.rms_eps)
        if spec.ffn == "moe":
            y, _ = moe_mod.apply_moe(p["ffn"], h2, cfg)
        else:
            y = apply_mlp(p["ffn"], h2, cfg.act)
        x = x + y
    return x, cache


def _cross_decode(p, x, ck, cv, cfg):
    """Single-query cross-attention against the cached encoder K/V.  As in
    the reference, nothing fills ``cross_k``/``cross_v``: decode attends to
    the zeros ``init_caches`` leaves there (ROADMAP queue C 1)."""
    b, _, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    qg = (x @ p["wq"]).reshape(b, hk, g, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) / math.sqrt(dh)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, cv.float())
    return out.reshape(b, 1, h * dh).to(x.dtype) @ p["wo"]


def decode_group(layers: list, caches: dict, x: torch.Tensor, pos, cfg,
                 spec: GroupSpec, *, ring: bool):
    """Walks the group's layers; each gets views of its slice of every
    stacked cache leaf and writes them in place.  Returns (x, caches)."""
    for i, layer_p in enumerate(layers):
        x, _ = decode_block(layer_p, x, tree_map(lambda c: c[i], caches), pos,
                            cfg, spec, ring=ring)
    return x, caches
