# Copy of src/repro/configs/__init__.py (no import of the JAX package).
"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

The 10 assigned archs + the paper's own serving model (llama31-8b).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, shape_applicable,
)

# arch id -> module name
_ARCH_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "starcoder2-7b": "starcoder2_7b",
    "deepseek-7b": "deepseek_7b",
    "minitron-4b": "minitron_4b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "zamba2-7b": "zamba2_7b",
    "mamba2-780m": "mamba2_780m",
    "chameleon-34b": "chameleon_34b",
    "whisper-medium": "whisper_medium",
    "llama31-8b": "llama31_8b",          # paper's own serving model
}

ASSIGNED_ARCHS = [a for a in _ARCH_MODULES if a != "llama31-8b"]


def get_config(name: str) -> ModelConfig:
    key = name.strip()
    if key.endswith("-reduced"):
        return get_config(key[: -len("-reduced")]).reduced()
    if key not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")
    return mod.CONFIG


def list_archs(include_paper_model: bool = False) -> list[str]:
    return list(_ARCH_MODULES) if include_paper_model else list(ASSIGNED_ARCHS)


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
    "shape_applicable", "get_config", "get_shape", "list_archs",
    "ASSIGNED_ARCHS",
]
