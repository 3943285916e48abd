"""Assigned-architecture registry: `get_config("<arch-id>")`; port of
the reference's `configs` package, its ten modules copied field for field.

Every module defines ARCH_ID + CONFIG (exact assigned dimensions).
`ModelConfig.reduced()` derives the smoke-test variant of the same family.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.config import ModelConfig

_MODULES = [
    "seamless_m4t_medium",
    "gemma_2b",
    "chatglm3_6b",
    "qwen3_1_7b",
    "deepseek_coder_33b",
    "jamba_1_5_large",
    "llama4_scout",
    "granite_moe_1b",
    "mamba2_780m",
    "pixtral_12b",
]

_REGISTRY: Dict[str, ModelConfig] = {}
for _m in _MODULES:
    mod = import_module(f"{__name__}.{_m}")
    _REGISTRY[mod.ARCH_ID] = mod.CONFIG


def arch_ids() -> List[str]:
    return list(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]
