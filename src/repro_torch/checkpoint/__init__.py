"""Flat-key npz checkpoints of nested tensors, and the FL loop's run state."""

from .ckpt import (load_checkpoint, load_run_state, save_checkpoint,
                   save_run_state)

__all__ = ["save_checkpoint", "load_checkpoint", "save_run_state",
           "load_run_state"]
