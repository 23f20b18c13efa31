"""Parameter-spec machinery: models declare shapes + logical axes once and
``init_params`` materializes them (counterpart of ``repro.models.spec``).

The draws are normal·scale, zeros or ones as in the reference, but from a
``torch.Generator`` — they do not reproduce ``jax.random``'s bits.  Tests
that compare against the reference bridge its weights instead
(``repro_torch.models.bridge``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


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
    generator: torch.Generator,
    dtype: torch.dtype,
    device: torch.device | str = "cpu",
) -> Any:
    """Materialize a (nested dict) spec tree into parameters.

    Leaves are drawn in the tree's insertion order from ``generator`` (a CPU
    generator: the draw is f32 on the host, then cast and moved), so one
    seed gives the same weights on every device."""

    def make(spec: PSpec) -> torch.Tensor:
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32)
        return (w * spec.scale).to(dtype=dt).to(device)

    def walk(node):
        if isinstance(node, PSpec):
            return make(node)
        return {k: walk(v) for k, v in node.items()}

    return walk(specs)
