"""Config registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)`` for the architectures ported so far."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (INPUT_SHAPES, LayerSpec, ModelConfig,
                                      ShapeConfig)

# arch-id -> module
ARCHITECTURES: Dict[str, str] = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
}


def list_architectures() -> List[str]:
    return list(ARCHITECTURES)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch!r}; have {list(ARCHITECTURES)}")
    return importlib.import_module(ARCHITECTURES[arch]).config()


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch!r}; have {list(ARCHITECTURES)}")
    return importlib.import_module(ARCHITECTURES[arch]).smoke_config()


__all__ = [
    "ARCHITECTURES", "INPUT_SHAPES", "LayerSpec", "ModelConfig",
    "ShapeConfig", "get_config", "get_smoke_config", "list_architectures",
]
