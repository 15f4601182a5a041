"""Partition rules for parameters, batches and decode caches.

Mirrors the reference's ``models/shardings.py``.  Axis convention
(:mod:`repro_torch.launch.mesh`): ``data`` = clients / batch, ``model`` =
within-client tensor parallelism, ``pod`` (multi-pod only) = hierarchical
client groups.

A spec here is the tuple of entries the reference's ``PartitionSpec``
holds (:func:`partition_spec`): per dimension an axis name, a tuple of
two or more axis names, or ``None``.
The rules are the reference's, name-based over its parameter tree
(:func:`repro_torch.models.model.param_tree`: group leaves stacked over
layers), and work on a model laid out on the ``meta`` device.  On one
card no tensor is placed by them: they are data that the train and serve
steps return, as the reference's bundles do, for a multi-card path to
read.

The activation context is the reference's too.  With it set (pod / FSDP
mode), :func:`constrain_residual` pins the residual stream's backward
cotangent to its forward dtype (:func:`_ct_cast`); the placement it would
also assert has no single-card counterpart.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.core.pytree import tree_map_with_path

__all__ = ["set_activation_sharding", "clear_activation_sharding",
           "constrain_residual", "partition_spec",
           "param_specs", "batch_spec", "cache_specs"]


# ---------------------------------------------------------------------------
# Activation sharding context
# ---------------------------------------------------------------------------

_ACT_CTX: dict = {"mesh": None}


def set_activation_sharding(mesh, batch_axes, feat_axis=None,
                            seq_axis=None) -> None:
    """The reference's signature; only ``mesh`` (set or ``None``) is kept,
    as the axes would only place activations, which one card does not."""
    _ACT_CTX["mesh"] = mesh


def clear_activation_sharding() -> None:
    _ACT_CTX["mesh"] = None


@functools.lru_cache(maxsize=None)
def _ct_cast(dtype_name: str):
    """Identity in forward; casts the cotangent to ``dtype`` in backward.

    The loss upcasts the logits to float32, so without it the residual
    stream's cotangent could flow back through the layers in float32; this
    barrier pins it to the compute dtype (the mixed-precision contract).
    """
    dt = getattr(torch, dtype_name)

    class CtCast(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.to(dt)

    return CtCast.apply


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, D) residual-stream tensor, with its backward cotangent
    pinned to its forward dtype while an activation context is set (a
    no-op without one, or for another rank)."""
    if _ACT_CTX["mesh"] is None or x.dim() != 3:
        return x
    return _ct_cast(str(x.dtype).removeprefix("torch."))(x)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def partition_spec(*entries) -> tuple:
    """``tuple(PartitionSpec(*entries))``: a tuple of one axis name stands
    for the name and an empty one for ``None``, as jax normalizes them."""
    def one(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(one(e) for e in entries)


def param_specs(params, cfg, *, model_size: int, data_size: int = 1) -> dict:
    """The spec of every leaf of the reference's parameter tree, as nested
    dicts.  ``params`` is a :class:`~repro_torch.models.model.Model` (a
    ``meta`` one draws nothing) or already the reference's tree."""
    if isinstance(params, nn.Module):
        from .model import param_tree
        params = param_tree(params)
    ms = model_size
    fsdp = cfg.fsdp

    def div(n: int) -> bool:
        return ms > 1 and n % ms == 0

    def fdiv(n: int) -> bool:
        return fsdp and data_size > 1 and n % data_size == 0

    heads_ok = div(cfg.n_heads) and ms > 0
    kv_ok = div(cfg.n_kv_heads)
    ssm_ok = div(cfg.ssm_heads) if cfg.ssm_heads else False
    vocab_ok = div(cfg.vocab)
    dmodel_f = "data" if fdiv(cfg.d_model) else None
    # when the output can't shard cleanly (head count, odd vocab), shard the
    # contraction dim over model instead
    dmodel_m = "model" if div(cfg.d_model) and not fsdp else None
    dinner_m = "model" if cfg.ssm_heads and div(cfg.d_inner) else None

    def rule(keys: list[str], leaf) -> tuple:
        name = keys[-1]
        stacked = any(k.startswith(("group", "enc_group")) for k in keys)
        in_moe = "ffn" in keys and cfg.n_experts > 0 and "shared" not in keys

        if name == "embed":
            spec = ("model" if vocab_ok else None,
                    dmodel_f if vocab_ok else (dmodel_f or dmodel_m))
        elif name == "lm_head":
            spec = (dmodel_f, "model" if vocab_ok else None)
        elif in_moe and name in ("we_g", "we_u"):
            spec = ("model" if div(cfg.n_experts) else None, dmodel_f, None)
        elif in_moe and name == "we_d":
            spec = ("model" if div(cfg.n_experts) else None, None, dmodel_f)
        elif in_moe and name == "router":
            spec = (dmodel_f, None)
        elif name in ("wg", "wu"):
            f_dim = leaf.shape[-1]
            spec = (dmodel_f, "model" if div(f_dim) else None)
        elif name == "wd":
            spec = ("model" if div(leaf.shape[-2]) else None, dmodel_f)
        elif name == "wq":
            spec = (dmodel_f or (None if heads_ok else dmodel_m),
                    "model" if heads_ok else None)
        elif name in ("wk", "wv"):
            spec = (dmodel_f or (None if kv_ok else dmodel_m),
                    "model" if kv_ok else None)
        elif name == "wo":
            if heads_ok:
                spec = ("model", dmodel_f)
            else:  # contraction over the flat H*dh dim is always sound
                hd = leaf.shape[-2]
                spec = ("model" if div(hd) else None, dmodel_f)
        # --- MLA ---
        elif name in ("wdkv", "wkr", "wdq"):
            spec = (dmodel_f, None)
        elif name in ("wuq", "wuk", "wuv"):
            spec = (None, "model" if heads_ok else None)
        # --- SSM ---
        elif name in ("w_x", "w_z"):
            spec = (dmodel_f or (None if ssm_ok else dmodel_m),
                    "model" if ssm_ok else None)
        elif name in ("w_B", "w_C", "w_dt"):
            spec = (dmodel_f or dmodel_m, None)
        elif name == "out_proj":
            spec = ("model" if (ssm_ok or dinner_m) else None, dmodel_f)
        else:  # norms, biases, convs, scalars, A_log, D, dt_bias, beta*
            spec = (None,) * (leaf.dim() - (1 if stacked else 0))

        if stacked:
            spec = (None,) + tuple(spec)
        return tuple(spec[:leaf.dim()]) if leaf.dim() else ()

    return tree_map_with_path(lambda path, leaf: rule(list(path), leaf),
                              params)


def batch_spec(kind: str, *, batch_divisible: bool, data_axes) -> dict:
    """Specs for the input batch dict."""
    da = data_axes if batch_divisible else None
    if kind in ("train", "prefill"):
        return {"tokens": partition_spec(da, None),
                "targets": partition_spec(da, None)}
    return {"token": partition_spec(da, None)}


def cache_specs(caches: dict, *, batch_divisible: bool, data_axes,
                model_size: int = 16) -> dict:
    """Decode-cache specs (every cache leaf stacked over layers: (L, B,
    ...)).  Batch over ``data`` when divisible; an attention cache's length
    over ``model`` when it divides."""
    da = data_axes if batch_divisible else None

    def rule(path, leaf) -> tuple:
        name = path[-1]
        if name in ("k", "v", "cross_k", "cross_v", "c_kv", "k_rope"):
            t = leaf.shape[2]
            tm = "model" if model_size > 1 and t % model_size == 0 else None
            return partition_spec(None, da, tm, *([None] * (leaf.dim() - 3)))
        return partition_spec(None, da, *([None] * (leaf.dim() - 2)))

    return tree_map_with_path(rule, caches)
