"""Architecture registry: ``get(arch_id)`` / ``smoke(arch_id)``.

Every assigned architecture is a module in this package exposing ``CONFIG``
(the exact published dims) and ``SMOKE`` (a reduced same-family variant for
CPU tests).  The modules are the port's own copies of ``repro/configs``,
with identical dims.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "internvl2-76b": "internvl2_76b",
    "mamba2-780m": "mamba2_780m",
    "musicgen-large": "musicgen_large",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2-7b": "qwen2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ARCHS", "SHAPES", "get", "smoke", "shape"]
