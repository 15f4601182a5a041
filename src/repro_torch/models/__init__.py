"""The model zoo of the port: the dense decoder (attention + gated MLP) of
every ArchConfig without experts, SSM, MLA or an encoder
(:mod:`repro_torch.configs`)."""

from .model import (decode_step, forward, init_caches, init_params, param_count,
                    params_from_jax)

__all__ = ["decode_step", "forward", "init_caches", "init_params",
           "param_count", "params_from_jax"]
