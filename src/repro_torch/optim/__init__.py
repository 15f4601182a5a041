"""Optimizers in the (init, update) style, on pytrees of tensors."""

from .optimizers import adam, apply_updates, momentum, sgd

__all__ = ["sgd", "momentum", "adam", "apply_updates"]
