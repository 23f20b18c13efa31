"""Architecture registry: ``--arch <id>`` resolves here.

Every architecture of the reference is registered; any other id raises
``KeyError``.  The assigned (arch, shape) cells are the reference's:
:func:`assigned_cells` and :func:`runnable_cells`.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, long_context_capable

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
# the assigned architectures, in the reference's order (opt-125m, the
# paper's own family, is not one of them)
ARCH_IDS: tuple[str, ...] = (
    "musicgen-medium", "qwen2.5-14b", "qwen3-32b", "granite-8b", "yi-34b", "xlstm-350m",
    "hymba-1.5b", "kimi-k2-1t-a32b", "dbrx-132b", "paligemma-3b",
)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def assigned_cells() -> list[tuple[str, str]]:
    """All 40 assigned (arch, shape) cells; :func:`runnable_cells` drops
    long_500k for the full-attention archs."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in assigned_cells()
            if s != "long_500k" or long_context_capable(get_config(a))]
