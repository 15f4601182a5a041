"""Public model API: init / forward / decode for the dense decoder.

Mirrors the reference's ``models/model.py``.  ``init_params`` returns a
:class:`Model`, an ``nn.Module`` whose ``nn.Parameter``s sit where the
reference's parameter tree puts its leaves (``embed``, ``final_norm``,
``group0[i].mix.wq``, ...), in the reference's ``(in, out)`` layout.
``forward`` and ``decode_step`` first make a nested dict of the
parameters cast to the compute dtype (:func:`cast_params`), as the
reference's do, and run the functional blocks on it.

``batch`` dict convention (prefill): ``{"tokens": (B, S) int}``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import prng

from . import transformer as tr
from .attention import Attention
from .layers import MLP, dense_init, init_rms, rms_norm

__all__ = ["Model", "init_params", "param_count", "cast_params", "forward",
           "init_caches", "decode_step", "params_from_jax"]


class Model(nn.Module):
    """``embed`` (vocab, d), ``final_norm`` (d,), ``group<i>`` (a
    ``ModuleList`` of blocks per group of :func:`~.transformer.group_plan`),
    and ``lm_head`` (d, vocab) when the embeddings are not tied."""

    def __init__(self, embed, final_norm, groups, lm_head=None):
        super().__init__()
        self.embed, self.final_norm = embed, final_norm
        if lm_head is not None:
            self.lm_head = lm_head
        for i, g in enumerate(groups):
            self.add_module(f"group{i}", g)


def _require_decoder_only(cfg) -> None:
    if cfg.is_enc_dec:
        raise NotImplementedError("the encoder-decoder is not ported yet "
                                  "(ROADMAP queue A11)")


def init_params(cfg, key: torch.Tensor, device=None) -> Model:
    """The reference's ``init_params(cfg, key)`` from the same threefry key
    tree (``split(key, 8)``, then per group ``split(., n_layers)`` and each
    block's splits), so the same key gives the same weights; on ``device``
    (the card unless told otherwise)."""
    _require_decoder_only(cfg)
    key = key.to(resolve_device(device))
    dt = getattr(torch, cfg.param_dtype)
    ks = prng.split(key, 8)
    embed = nn.Parameter((prng.normal(ks[0], (cfg.vocab, cfg.d_model))
                          * 0.02).to(dt))
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = dense_init(ks[1], cfg.d_model, cfg.vocab, dt, scale=0.02)
    groups = [tr.init_group(ks[2 + i], cfg, spec)
              for i, spec in enumerate(tr.group_plan(cfg))]
    return Model(embed, init_rms(cfg.d_model, dt, key.device), groups, lm_head)


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _tree(module: nn.Module, dtype):
    """A module's parameters as nested dicts (a ``ModuleList`` as a list),
    float leaves cast to ``dtype``."""
    if isinstance(module, nn.ModuleList):
        return [_tree(m, dtype) for m in module]
    out = {n: (p.to(dtype) if p.dtype in (torch.float32, torch.bfloat16) else p)
           for n, p in module.named_parameters(recurse=False)}
    out.update({n: _tree(m, dtype) for n, m in module.named_children()})
    return out


def cast_params(params: Model, cfg) -> dict:
    """Mixed precision: the parameters in compute_dtype, as nested dicts.
    In bfloat16 this copies every float32 parameter on every call, as the
    reference's ``forward`` does."""
    return _tree(params, getattr(torch, cfg.compute_dtype))


def _embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))
    return x * (cfg.d_model ** 0.5) if cfg.scale_embed else x


def _head(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward(params: Model, cfg, batch: dict, *, last_only: bool = False):
    """Full-sequence forward.  Returns (logits (B, S, V), aux_loss).

    ``last_only=True`` computes logits for the final position only (prefill
    serving): at 32k x 152k-vocab the full logits tensor is 20 GB in f32."""
    _require_decoder_only(cfg)
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    pos = torch.arange(s, device=tokens.device)
    for i, spec in enumerate(tr.group_plan(cfg)):
        x = tr.apply_group(params[f"group{i}"], x, cfg, spec, positions=pos)
    if last_only:
        x = x[:, -1:, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, cache_len: int, dtype=None, device=None) -> dict:
    """Zeroed KV caches per group, stacked over the group's layers, in the
    compute dtype unless given; on ``device`` (the card unless told
    otherwise)."""
    _require_decoder_only(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.compute_dtype) if dtype is None else dtype
    return {f"group{i}": tr.init_block_cache(cfg, spec, batch, cache_len, dtype,
                                             device, spec.n_layers)
            for i, spec in enumerate(tr.group_plan(cfg))}


def decode_step(params: Model, cfg, token: torch.Tensor, caches: dict, pos, *,
                ring: bool = False):
    """One-token decode: token (B, 1) int, pos a scalar or (B,) positions.

    Returns (logits (B, 1, V), caches); the caches are updated in place."""
    _require_decoder_only(cfg)
    params = cast_params(params, cfg)
    x = _embed(params, cfg, token)
    for i, spec in enumerate(tr.group_plan(cfg)):
        x, caches[f"group{i}"] = tr.decode_group(
            params[f"group{i}"], caches[f"group{i}"], x, pos, cfg, spec,
            ring=ring)
    return _head(params, cfg, x), caches


# ---------------------------------------------------------------------------
# weights carried across from the reference
# ---------------------------------------------------------------------------

def params_from_jax(np_params: dict, cfg, device=None) -> Model:
    """The reference's parameter tree (numpy arrays; each group leaf stacked
    over layers on axis 0) as the port's model, on ``device`` (the card
    unless told otherwise)."""
    _require_decoder_only(cfg)
    device = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)

    def par(a) -> nn.Parameter:
        return nn.Parameter(torch.tensor(np.asarray(a, np.float32), dtype=dt,
                                         device=device))

    groups = []
    for i, spec in enumerate(tr.group_plan(cfg)):
        tr._require_ported(spec)
        g = np_params[f"group{i}"]
        blocks = []
        for j in range(spec.n_layers):
            mix = g["mix"]
            norms = ((par(mix["q_norm"][j]), par(mix["k_norm"][j]))
                     if cfg.qk_norm else ())
            attn = Attention(*(par(mix[n][j]) for n in ("wq", "wk", "wv", "wo")),
                             *norms)
            if spec.ffn == "none":
                blocks.append(tr.Block(par(g["ln1"][j]), attn))
                continue
            ffn = MLP(*(par(g["ffn"][n][j]) for n in ("wg", "wu", "wd")))
            blocks.append(tr.Block(par(g["ln1"][j]), attn, par(g["ln2"][j]), ffn))
        groups.append(nn.ModuleList(blocks))
    lm_head = None if cfg.tie_embeddings else par(np_params["lm_head"])
    return Model(par(np_params["embed"]), par(np_params["final_norm"]), groups,
                 lm_head)
