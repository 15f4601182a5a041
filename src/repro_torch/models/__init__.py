"""The model zoo of the port: every ArchConfig of :mod:`repro_torch.configs`
(dense decoders, MoE, MLA, Mamba-2 SSD, the Hymba hybrid and the Whisper
encoder-decoder), for prefill and decode."""

from .model import (decode_step, forward, init_caches, init_params, param_count,
                    params_from_jax)

__all__ = ["decode_step", "forward", "init_caches", "init_params",
           "param_count", "params_from_jax"]
