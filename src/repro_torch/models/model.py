"""Public model API: init / loss / forward / decode for every ArchConfig.

Mirrors the reference's ``models/model.py``.  ``init_params`` returns a
:class:`Model`, an ``nn.Module`` whose ``nn.Parameter``s sit where the
reference's parameter tree puts its leaves (``embed``, ``final_norm``,
``group0[i].mix.wq``, ``group1[i].ffn.we_g``, ``enc_group0[i].mix.wq``,
...), in the reference's ``(in, out)`` layout.  ``forward`` and
``decode_step`` first make a nested dict of the parameters cast to the
compute dtype (:func:`cast_params`), as the reference's do, and run the
functional blocks on it.

``batch`` dict convention (train / prefill): ``{"tokens": (B, S) int}``,
plus ``"targets"`` (B, S) int for the loss and ``"frames"`` (B,
source_len, d_model) float for the encoder-decoder.

:func:`reference_leaves` and :func:`param_tree` give the reference's view
of the same parameters: its tree, whose dict keys flatten in sorted order
and whose group leaves are stacked over the group's layers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import prng

from . import transformer as tr
from .layers import dense_init, init_rms, rms_norm, sinusoidal_positions

__all__ = ["Model", "init_params", "param_count", "cast_params", "forward",
           "loss_fn", "init_caches", "decode_step", "jax_leaf",
           "params_from_jax", "reference_leaves", "param_tree"]


class Model(nn.Module):
    """``embed`` (vocab, d), ``final_norm`` (d,), ``group<i>`` (a
    ``ModuleList`` of blocks per group of :func:`~.transformer.group_plan`),
    ``lm_head`` (d, vocab) when the embeddings are not tied, and for the
    encoder-decoder ``enc_group0`` (the encoder's blocks) and ``enc_norm``."""

    def __init__(self, embed, final_norm, groups, lm_head=None, *,
                 enc_group0=None, enc_norm=None):
        super().__init__()
        self.embed, self.final_norm = embed, final_norm
        if lm_head is not None:
            self.lm_head = lm_head
        for i, g in enumerate(groups):
            self.add_module(f"group{i}", g)
        if enc_group0 is not None:
            self.enc_group0, self.enc_norm = enc_group0, enc_norm


def init_params(cfg, key: torch.Tensor, device=None) -> Model:
    """The reference's ``init_params(cfg, key)`` from the same threefry key
    tree (``split(key, 8)``, then per group ``split(., n_layers)`` and each
    block's splits), so the same key gives the same weights; on ``device``
    (the card unless told otherwise; ``"meta"`` gives the module's shapes
    and dtypes without drawing anything)."""
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
    enc = {}
    if cfg.is_enc_dec:
        enc = dict(enc_group0=tr.init_group(ks[6], cfg, tr.encoder_plan(cfg)[0]),
                   enc_norm=init_rms(cfg.d_model, dt, key.device))
    return Model(embed, init_rms(cfg.d_model, dt, key.device), groups, lm_head,
                 **enc)


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


def _encode(params: dict, cfg, frames: torch.Tensor) -> torch.Tensor:
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = tr.apply_group(params["enc_group0"], x, cfg, tr.encoder_plan(cfg)[0],
                          positions=pos, arange_positions=True)
    return rms_norm(x, params["enc_norm"], cfg.rms_eps)


def forward(params: Model, cfg, batch: dict, *, last_only: bool = False):
    """Full-sequence forward.  Returns (logits (B, S, V), aux_loss), the
    aux loss the MoE layers' summed (0 without experts).

    ``last_only=True`` computes logits for the final position only (prefill
    serving): at 32k x 152k-vocab the full logits tensor is 20 GB in f32."""
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    pos = torch.arange(s, device=tokens.device)
    enc_out, enc_pos = None, None
    if cfg.is_enc_dec:
        enc_out = _encode(params, cfg, batch["frames"])
        enc_pos = torch.arange(enc_out.shape[1], device=enc_out.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(tr.group_plan(cfg)):
        x, aux_g = tr.apply_group(params[f"group{i}"], x, cfg, spec, positions=pos,
                                  arange_positions=True, enc_out=enc_out,
                                  enc_positions=enc_pos)
        aux = aux + aux_g
    if last_only:
        x = x[:, -1:, :]
    return _head(params, cfg, x), aux


def loss_fn(params: Model, cfg, batch: dict) -> torch.Tensor:
    """Next-token cross entropy (+ 0.01 x the MoE aux loss), microbatch-safe:
    the mean over (B, S) of ``logsumexp(logits) - logits[target]``, in
    float32."""
    logits, aux = forward(params, cfg, batch)
    logits = logits.float()
    targets = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    ce = (logz - gold).mean()
    return ce + 0.01 * aux


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, cache_len: int, dtype=None, device=None) -> dict:
    """Zeroed KV caches per group, stacked over the group's layers, in the
    compute dtype unless given; on ``device`` (the card unless told
    otherwise)."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.compute_dtype) if dtype is None else dtype
    return {f"group{i}": tr.init_block_cache(cfg, spec, batch, cache_len, dtype,
                                             device, spec.n_layers)
            for i, spec in enumerate(tr.group_plan(cfg))}


def decode_step(params: Model, cfg, token: torch.Tensor, caches: dict, pos, *,
                ring: bool = False):
    """One-token decode: token (B, 1) int, pos a scalar or (B,) positions.

    Returns (logits (B, 1, V), caches); the caches are updated in place."""
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

def jax_leaf(np_params: dict, name: str) -> np.ndarray:
    """The reference's leaf (numpy, one layer of a stacked group leaf) for
    the port's parameter ``name``: ``group1.0.ffn.we_g`` is
    ``np_params["group1"]["ffn"]["we_g"][0]``."""
    head, *rest = name.split(".")
    stacked = head.startswith(("group", "enc_group"))
    layer = int(rest.pop(0)) if stacked else None
    leaf = np_params[head]
    for part in rest:
        leaf = leaf[part]
    return np.asarray(leaf)[layer] if stacked else np.asarray(leaf)


def params_from_jax(np_params: dict, cfg, device=None) -> Model:
    """The reference's parameter tree (numpy arrays; each group leaf stacked
    over layers on axis 0) as the port's model, on ``device`` (the card
    unless told otherwise): the module is laid out on the ``meta`` device
    by :func:`init_params` and each parameter is filled from its leaf
    (:func:`jax_leaf`)."""
    device = resolve_device(device)
    model = init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = jax_leaf(np_params, name)
            if tuple(p.shape) != leaf.shape:
                raise ValueError(f"{name}: the reference's leaf is "
                                 f"{leaf.shape}, the port's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return model


# ---------------------------------------------------------------------------
# the reference's tree over the port's parameters
# ---------------------------------------------------------------------------

def reference_leaves(params: Model) -> list:
    """``[(path, parameters)]``, one entry per leaf of the reference's
    parameter tree, in the order ``jax.tree_util`` flattens it: paths (the
    reference's dict keys, e.g. ``("group0", "mix", "wq")``) in sorted
    order, and for a group leaf the port's per-layer parameters in layer
    order (the reference stacks them on axis 0; layer numbers sort as
    numbers, never as strings).  A leaf outside the groups holds one
    parameter."""
    leaves: dict = {}
    for name, p in params.named_parameters():
        head, *rest = name.split(".")
        layer = (int(rest.pop(0)) if head.startswith(("group", "enc_group"))
                 else 0)
        leaves.setdefault((head, *rest), []).append((layer, p))
    return [(path, [p for _, p in sorted(leaves[path], key=lambda lp: lp[0])])
            for path in sorted(leaves)]


def _is_stacked(path: tuple) -> bool:
    return path[0].startswith(("group", "enc_group"))


def param_tree(params: Model) -> dict:
    """The reference's parameter tree: nested dicts whose group leaves are
    the layers' parameters stacked on axis 0 (a copy; on the ``meta``
    device, shapes alone)."""
    tree: dict = {}
    for path, ps in reference_leaves(params):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (torch.stack([p.detach() for p in ps])
                          if _is_stacked(path) else ps[0].detach())
    return tree
