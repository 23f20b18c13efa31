"""Architecture registry: ``--arch <id>`` resolves here.

Every architecture of the reference is registered; any other id raises
``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: dict[str, str] = {
    "opt-125m": "opt_125m",
    "hymba-1.5b": "hymba_1_5b",
    "granite-8b": "granite_8b",
    "yi-34b": "yi_34b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-32b": "qwen3_32b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-medium": "musicgen_medium",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "xlstm-350m": "xlstm_350m",
}


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
