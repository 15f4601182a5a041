"""Hand-written CUDA kernels of the port, their plain-torch versions and
the oracles of every reference kernel (:mod:`.ref`).

The sources live in ``csrc/`` and are compiled at first use
(:mod:`.build`); importing this package compiles nothing.
"""

from . import (bitpack, build, flash_attention, gather_quant, ops, ref,
               stoch_quant, vote_pack, vote_popcount)

__all__ = ["bitpack", "build", "flash_attention", "gather_quant", "ops", "ref",
           "stoch_quant", "vote_pack", "vote_popcount"]
