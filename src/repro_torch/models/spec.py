"""Parameter-spec machinery: models declare shapes + logical axes once and
``init_params`` materializes them (counterpart of ``repro.models.spec``).

The draws replay the reference's: a normal leaf is
``jax.random.normal(fold_in_path(key, path)) * scale`` in f32, cast to the
leaf dtype (``utils.jax_random``), so one seed gives the reference's
weights bit for bit.  The multiply and the cast are elementwise, so each
drawn chunk is scaled and cast straight into the leaf: no leaf is ever
whole in f32 beside the weights (qwen2.5-14b's ``w_gate`` would take 13.6
GB so, qwen3-32b's 33.6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.utils import jax_random
from repro_torch.utils.tree import fold_in_path, map_with_path


@dataclass(frozen=True)
class PSpec:
    """Declarative spec for one parameter leaf."""

    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02
    dtype: Optional[torch.dtype] = None  # None -> model default

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_params(
    specs: Any,
    key,
    dtype: torch.dtype,
    device: torch.device | str = "cpu",
) -> Any:
    """Materialize a (nested dict) spec tree into parameters on ``device``.

    ``key`` is a ``jax_random`` key (``PRNGKey(seed)``); each normal leaf
    draws from the key folded with its tree path, on ``device``."""

    def make(path: str, spec: PSpec) -> torch.Tensor:
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        w = torch.empty(spec.shape, dtype=dt, device=device)
        flat = w.view(-1)
        for start, z in jax_random.normal_chunks(fold_in_path(key, path), w.numel(), device):
            flat[start:start + z.numel()] = z * spec.scale  # the copy casts to dt
        return w

    return map_with_path(make, specs)
