"""Architecture registry of the port: the reference's ``ARCH_NAMES``, with
``get_config`` / ``smoke_config`` for every one of them (``PORTED``: the
dense decoders, deepseek-moe-16b and olmoe-1b-7b, phi-3-vision-4.2b,
mamba2-2.7b, hymba-1.5b and seamless-m4t-medium)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_NAMES", "PORTED", "get_config", "smoke_config"]

ARCH_NAMES = (
    "seamless_m4t_medium",
    "granite_3_8b",
    "tinyllama_1_1b",
    "qwen2_5_32b",
    "llama3_8b",
    "phi_3_vision_4_2b",
    "deepseek_moe_16b",
    "olmoe_1b_7b",
    "hymba_1_5b",
    "mamba2_2_7b",
)
PORTED = ("tinyllama_1_1b", "mamba2_2_7b", "llama3_8b", "granite_3_8b",
          "qwen2_5_32b", "hymba_1_5b", "seamless_m4t_medium",
          "deepseek_moe_16b", "olmoe_1b_7b", "phi_3_vision_4_2b")


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_NAMES:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    """The published full-width configuration of ``name``."""
    return _module(name).config()


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke()
