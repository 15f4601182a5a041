"""Minimal functional optimizers in the (init, update) style.

FL local training in the paper is plain SGD (FedAvg's inner loop); the
aggregated model delta is applied with :func:`apply_updates`.  Adam is
provided for general use.

Parameters, gradients and states are pytrees of tensors: a tensor, or
dicts, lists and tuples of them, mapped leaf by leaf with
:func:`repro_torch.core.pytree.tree_map`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import xla_math
from repro_torch.core.pytree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "momentum", "adam", "apply_updates"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        leaf = tree_leaves(params)[0]
        return {"m": z, "v": tree_map(torch.zeros_like, z),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.to(torch.float32)), state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=t.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), tf)
        upd = tree_map(lambda m_, v_: -lr * (m_ / bc1)
                       / (xla_math.sqrt(v_ / bc2) + eps), m, v)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(
        lambda p, u: (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype),
        params, updates)
