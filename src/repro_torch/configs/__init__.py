"""Architecture registry: ``--arch <id>`` resolves here.

Only the architectures the port has reached are registered; any other id
raises ``KeyError`` naming the ROADMAP queue that tracks it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: dict[str, str] = {
    "opt-125m": "opt_125m",
    "hymba-1.5b": "hymba_1_5b",
}


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md Queue A, item 12b "
            f"'Other model families'); available: {sorted(_ARCH_MODULES)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
