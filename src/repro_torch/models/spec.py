"""Parameter-spec machinery: models declare shapes + logical axes once and
``init_params`` materializes them (counterpart of ``repro.models.spec``).

The draws replay the reference's: a normal leaf is
``jax.random.normal(fold_in_path(key, path)) * scale`` in f32, cast to the
leaf dtype (``utils.jax_random``), so one seed gives the reference's
weights bit for bit.  Each element's bits depend on its flat index alone,
so a sharded run's rank draws its shard of a leaf without the rest.  The
multiply and the cast are elementwise, so each drawn chunk is scaled and
cast straight into the leaf: no leaf is ever whole in f32 beside the
weights (qwen2.5-14b's ``w_gate`` would take 13.6
GB so, qwen3-32b's 33.6).

:func:`abstract_params` and :func:`logical_axes` read the same spec tree:
meta tensors of each leaf's shape and dtype (the reference's
ShapeDtypeStructs), and each leaf's logical axes, which
``distributed.sharding`` maps onto a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

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
    slices_of: Optional[Callable] = None,
) -> Any:
    """Materialize a (nested dict) spec tree into parameters on ``device``.

    ``key`` is a ``jax_random`` key (``PRNGKey(seed)``); each normal leaf
    draws from the key folded with its tree path, on ``device``, each
    element by its flat index in the leaf.  ``slices_of(path, shape)`` (one
    slice per dim) gives a sharded run's rank its shard of each leaf: bit
    for bit that slice of the whole draw, and nothing else is drawn."""

    def make(path: str, spec: PSpec) -> torch.Tensor:
        dt = spec.dtype or dtype
        sl = (slices_of(path, spec.shape) if slices_of is not None
              else (slice(None),) * len(spec.shape))
        shape = tuple(len(range(*s.indices(n))) for s, n in zip(sl, spec.shape))
        if spec.init in ("zeros", "ones"):
            return (torch.zeros if spec.init == "zeros" else torch.ones)(shape, dtype=dt,
                                                                          device=device)
        w = torch.empty(shape, dtype=dt, device=device)
        strides = tuple(int(x) for x in torch.empty(spec.shape, device="meta").stride())
        starts = tuple(s.indices(n)[0] for s, n in zip(sl, spec.shape))
        _fill_normal(w, fold_in_path(key, path), 0, starts, strides, spec.scale)
        return w

    return map_with_path(make, specs)


def _fill_normal(out: torch.Tensor, key, base: int, starts: tuple, strides: tuple,
                 scale: float) -> None:
    """Fill ``out``, a block of a leaf, with the leaf's ``normal * scale``
    draws: block element (i, j, ..) is the leaf's flat element ``base +
    Σ (starts[d] + i_d)·strides[d]`` (``strides`` row-major), drawn in
    blocks of rows of at most ``jax_random._CHUNK`` elements."""
    if out.numel() == 0:
        return
    if out.dim() == 0:
        out, starts, strides = out.view(1), (0,), (1,)
    per_row = out[0].numel()
    if out.dim() > 1 and per_row > jax_random._CHUNK:  # a row alone is too big
        for r in range(out.shape[0]):
            _fill_normal(out[r], key, base + (starts[0] + r) * strides[0], starts[1:],
                         strides[1:], scale)
        return
    step = max(1, jax_random._CHUNK // per_row)
    for r0 in range(0, out.shape[0], step):
        block = out[r0:r0 + step]
        idx = torch.full((), base, dtype=torch.int64, device=out.device)
        for d, n in enumerate(block.shape):
            first = starts[d] + (r0 if d == 0 else 0)
            ar = torch.arange(first, first + n, dtype=torch.int64, device=out.device)
            idx = idx.unsqueeze(-1) + ar * strides[d]
        block.copy_(jax_random.normal_at(key, idx) * scale)  # the copy casts


def abstract_params(specs: Any, dtype: torch.dtype) -> Any:
    """Meta tensors of every leaf's shape and dtype (no storage)."""
    return map_with_path(
        lambda _, spec: torch.empty(spec.shape, dtype=spec.dtype or dtype, device="meta"), specs)


def logical_axes(specs: Any) -> Any:
    """Each leaf's tuple of logical axis names, in the params' tree layout."""
    return map_with_path(lambda _, spec: spec.axes, specs)
