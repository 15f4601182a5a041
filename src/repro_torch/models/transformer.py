"""The model trunk: grouped layer stacks of identical blocks.

Mirrors the reference's ``models/transformer.py`` for the ``"attn"`` mixer
with the ``"mlp"`` FFN (the dense decoder).  Where the reference stacks a
group's parameters and ``lax.scan``s over them, the port holds an
``nn.ModuleList`` of blocks and walks it in Python.  The reference's
``constrain_residual`` (mesh sharding of the residual stream) and
``jax.checkpoint`` (remat for training) have no single-card counterpart
in a forward-only slice and are left out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.core import prng

from . import attention as attn_mod
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


#: what the port cannot run yet, and the ROADMAP item that brings it
_NOT_PORTED = {
    "mla": "the MLA mixer (ROADMAP queue A11: models/mla.py)",
    "ssm": "the SSM mixer (ROADMAP queue A11: models/ssm.py)",
    "hybrid": "the hybrid mixer (ROADMAP queue A11: models/hybrid.py)",
    "moe": "the MoE FFN (ROADMAP queue A11: models/moe.py)",
    "cross_attn": "cross-attention (ROADMAP queue A11: the encoder-decoder)",
}


def _require_ported(spec: GroupSpec) -> None:
    for what in (spec.mixer, spec.ffn, "cross_attn" if spec.cross_attn else ""):
        if what in _NOT_PORTED:
            raise NotImplementedError(f"{_NOT_PORTED[what]} is not ported yet")


# ---------------------------------------------------------------------------
# Single block init/apply
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder block: ``ln1``, ``mix`` (attention), and with an FFN
    ``ln2`` and ``ffn`` (gated MLP)."""

    def __init__(self, ln1, mix, ln2=None, ffn=None):
        super().__init__()
        self.ln1, self.mix = ln1, mix
        if ffn is not None:
            self.ln2, self.ffn = ln2, ffn


def init_block(key: torch.Tensor, cfg, spec: GroupSpec) -> Block:
    _require_ported(spec)
    dt = getattr(torch, cfg.param_dtype)
    ks = prng.split(key, 4)
    ln1 = init_rms(cfg.d_model, dt, key.device)
    mix = attn_mod.init_attention(ks[0], cfg)
    if spec.ffn == "none":
        return Block(ln1, mix)
    return Block(ln1, mix, init_rms(cfg.d_model, dt, key.device),
                 init_mlp(ks[1], cfg.d_model, spec.d_ff, dt))


def apply_block(p: dict, x: torch.Tensor, cfg, spec: GroupSpec, *, positions,
                arange_positions: bool = False):
    """Full-sequence block (prefill).  Returns x (the reference also
    returns the MoE aux loss, always 0 for the dense block).
    ``arange_positions`` declares ``positions`` to be ``arange(S)``
    (:func:`~repro_torch.models.attention.multihead_attention`)."""
    _require_ported(spec)
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + attn_mod.multihead_attention(p["mix"], h, cfg, positions=positions,
                                         causal=spec.causal,
                                         arange_positions=arange_positions)
    if spec.ffn != "none":
        h2 = rms_norm(x, p["ln2"], cfg.rms_eps)
        x = x + apply_mlp(p["ffn"], h2, cfg.act)
    return x


# ---------------------------------------------------------------------------
# Grouped stacks
# ---------------------------------------------------------------------------

def init_group(key: torch.Tensor, cfg, spec: GroupSpec) -> nn.ModuleList:
    """``spec.n_layers`` blocks from ``split(key, n_layers)``, the keys the
    reference's ``vmap`` over stacked layers uses."""
    keys = prng.split(key, spec.n_layers)
    return nn.ModuleList(init_block(keys[i], cfg, spec)
                         for i in range(spec.n_layers))


def apply_group(layers: list, x: torch.Tensor, cfg, spec: GroupSpec, *,
                positions, arange_positions: bool = False):
    for layer_p in layers:
        x = apply_block(layer_p, x, cfg, spec, positions=positions,
                        arange_positions=arange_positions)
    return x


# ---------------------------------------------------------------------------
# Decode blocks (single token, cached)
# ---------------------------------------------------------------------------

def init_block_cache(cfg, spec: GroupSpec, batch: int, length: int, dtype,
                     device, n_layers: int) -> dict:
    """A group's caches, stacked over its layers on axis 0 as in the
    reference: ``{"mix": {"k", "v"}}`` of (n_layers, B, T, Hk, dh),
    allocated once (no per-layer copies to stack: at a 32k cache they are
    as large as the result)."""
    _require_ported(spec)
    one = attn_mod.init_kv_cache(cfg, batch, length, dtype, "meta")
    return {"mix": {n: torch.zeros((n_layers, *c.shape), dtype=dtype,
                                   device=device) for n, c in one.items()}}


def decode_block(p: dict, x: torch.Tensor, cache: dict, pos, cfg,
                 spec: GroupSpec, *, ring: bool):
    """One token through one block; ``cache`` (this layer's) is updated in
    place and returned."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    mix, cache["mix"] = attn_mod.decode_attention(p["mix"], h, cache["mix"],
                                                  pos, cfg, ring=ring)
    x = x + mix
    if spec.ffn != "none":
        h2 = rms_norm(x, p["ln2"], cfg.rms_eps)
        x = x + apply_mlp(p["ffn"], h2, cfg.act)
    return x, cache


def decode_group(layers: list, caches: dict, x: torch.Tensor, pos, cfg,
                 spec: GroupSpec, *, ring: bool):
    """Walks the group's layers; each writes its slice of the stacked
    caches in place.  Returns (x, caches)."""
    _require_ported(spec)
    for i, layer_p in enumerate(layers):
        layer_c = {"mix": {n: c[i] for n, c in caches["mix"].items()}}
        x, _ = decode_block(layer_p, x, layer_c, pos, cfg, spec, ring=ring)
    return x, caches
