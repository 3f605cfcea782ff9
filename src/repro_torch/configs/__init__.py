"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``,
the same ids as the reference's ``repro.configs``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeSpec, supports_shape,
)

_ARCH_MODULES = {
    "deepseek-67b": "deepseek_67b",
    "yi-6b": "yi_6b",
    "llama3-8b": "llama3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "whisper-small": "whisper_small",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
    "supports_shape",
]
