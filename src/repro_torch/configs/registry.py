"""Architecture registry: ``get(name)`` / ``get_smoke(name)`` / ``ARCHS``."""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "hymba_1p5b",
    "gemma_2b",
    "qwen3_0p6b",
    "yi_6b",
    "whisper_tiny",
    "granite_moe_1b",
    "mamba2_130m",
    "deepseek_v2_236b",
    "command_r_plus_104b",
    "chameleon_34b",
)

# CLI aliases (the assignment spells them with dashes)
ALIASES = {
    "hymba-1.5b": "hymba_1p5b",
    "gemma-2b": "gemma_2b",
    "qwen3-0.6b": "qwen3_0p6b",
    "yi-6b": "yi_6b",
    "whisper-tiny": "whisper_tiny",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "mamba2-130m": "mamba2_130m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "command-r-plus-104b": "command_r_plus_104b",
    "chameleon-34b": "chameleon_34b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()


def all_configs():
    return {a: get(a) for a in ARCH_IDS}
