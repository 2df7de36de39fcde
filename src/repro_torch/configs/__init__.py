"""Assigned-architecture configs: ``get(arch_id)`` -> the full config, ``get_smoke`` -> the reduced one."""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

from .base import ModelConfig, SHAPES, ShapeCell, shape_by_name

_MODULES: Dict[str, str] = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "xlstm-350m": "xlstm_350m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-7b": "deepseek_7b",
    "smollm-360m": "smollm_360m",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "whisper-large-v3": "whisper_large_v3",
}

ARCHS = tuple(_MODULES)


def get(arch: str) -> ModelConfig:
    return _module(arch).full()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def _module(arch: str):
    try:
        mod_name = _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}") from None
    return importlib.import_module(f".{mod_name}", __package__)


__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "ARCHS", "get", "get_smoke", "shape_by_name"]
