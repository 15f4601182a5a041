"""Architecture configs for the 10 assigned architectures + input shapes
(copied from the reference's ``repro/configs``; plain dataclasses)."""

from .base import (ArchConfig, InputShape, INPUT_SHAPES, SHAPES_BY_NAME,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
from .registry import ARCH_IDS, ALIASES, all_configs, get, get_smoke

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "SHAPES_BY_NAME",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "ARCH_IDS", "ALIASES", "all_configs", "get", "get_smoke"]
