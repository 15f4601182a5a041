"""The model zoo of the port: every ArchConfig of :mod:`repro_torch.configs`
(dense decoders, MoE, MLA, Mamba-2 SSD, the Hymba hybrid and the Whisper
encoder-decoder), for training, prefill and decode."""

from .model import (decode_step, forward, init_caches, init_params, loss_fn,
                    param_count, param_tree, params_from_jax, reference_leaves)
from .shardings import batch_spec, cache_specs, param_specs

__all__ = ["decode_step", "forward", "init_caches", "init_params", "loss_fn",
           "param_count", "param_tree", "params_from_jax", "reference_leaves",
           "batch_spec", "cache_specs", "param_specs"]
