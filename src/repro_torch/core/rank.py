"""Layer-wise rank selection, the paper's Eq. 7 (counterpart of
``repro.core.rank``).

    r_l = min( { Rank(W_{l_b}) }_{W in block b}, r_max )

``Rank(W)`` is the number of singular values above ``threshold · σ_max(W)``,
estimated for a large matrix from a Gaussian sketch.  This is the
reference's numpy, call for call (the same ``np.random.default_rng(seed)``
sketch, the same SVD, the same block grouping by ``_BLOCK_RE`` over the
leaves' path strings), so the ranks and masks come out equal, not merely
close.  A leaf reaches numpy as f32 on the host (a bf16 tensor widens
exactly).  It runs once, at setup.

What the grouping does to a stacked model: the port's paths
(``['blocks']['wq']``) hold no layer digit, so every low-rank leaf falls in
the one block ``__global__``; leaves of different batch shapes (the
embedding ``()``, the stacked block leaves ``(L,)``) then share one scalar
minimum.  A stacked ``[L, D]`` norm scale counts as a matrix when L >= 8,
and at its zero init it has rank 1, so full-width opt-125m selects r = 1
for every leaf, as the reference does.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.cpd import is_lowrank_leaf
from repro_torch.utils.tree import map_with_path

# the layer-block index in a leaf path, e.g. "['blocks']['3']['attn']..."
_BLOCK_RE = re.compile(r"(?:blocks?|layers?)['\]\[]*(\d+)")


def spectral_rank(
    w: np.ndarray,
    threshold: float = 0.25,
    sketch_dim: Optional[int] = None,
    seed: int = 0,
) -> int:
    """#{σ_i > threshold · σ_max} for one 2-D matrix."""
    w = np.asarray(w, dtype=np.float32)
    m, n = w.shape
    if sketch_dim is not None and min(m, n) > sketch_dim:
        rng = np.random.default_rng(seed)
        if n >= m:
            g = rng.standard_normal((n, sketch_dim), dtype=np.float32)
            w = w @ (g / np.sqrt(sketch_dim))
        else:
            g = rng.standard_normal((sketch_dim, m), dtype=np.float32)
            w = (g / np.sqrt(sketch_dim)) @ w
    s = np.linalg.svd(w, compute_uv=False)
    if s.size == 0 or s[0] == 0.0:
        return 1
    return max(1, int(np.sum(s > threshold * s[0])))


def _host_f32(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, dtype=np.float32)


def leaf_spectral_ranks(
    leaf: Any,
    threshold: float = 0.25,
    sketch_dim: Optional[int] = None,
) -> np.ndarray:
    """Per-batch-element ranks of a stacked leaf (..., m, n) -> (...) ints."""
    arr = _host_f32(leaf)
    batch_shape = arr.shape[:-2]
    flat = arr.reshape((-1,) + arr.shape[-2:])
    ranks = np.array(
        [spectral_rank(flat[i], threshold, sketch_dim, seed=i) for i in range(flat.shape[0])],
        dtype=np.int32,
    )
    return ranks.reshape(batch_shape) if batch_shape else ranks[0]


def _block_id(path: str) -> str:
    m = _BLOCK_RE.search(path)
    return m.group(1) if m else "__global__"


def select_ranks(
    params: Any,
    threshold: float = 0.25,
    r_max: int = 64,
    sketch_dim: Optional[int] = 512,
) -> tuple[dict, dict]:
    """Eq. 7 over a parameter tree: ``(ranks, rank_masks)``.

    ``ranks`` {path: int}: each low-rank leaf's factor width, the minimum
    over its block capped at ``r_max`` (for a stacked leaf the largest of
    its layers', so shapes are static).  ``rank_masks`` {path: f32 (batch...,
    r) 0/1 numpy array}: for a stacked leaf whose layers' ranks differ, row
    l keeps that layer's leading components (``core.cpd.CPDFactor``)."""
    raw: dict[str, np.ndarray] = {}
    shapes: dict[str, tuple] = {}

    def visit(path: str, leaf: Any) -> Any:
        if is_lowrank_leaf(path, leaf):
            raw[path] = np.atleast_1d(leaf_spectral_ranks(leaf, threshold, sketch_dim))
            shapes[path] = tuple(leaf.shape)
        return leaf

    map_with_path(visit, params)

    by_block: dict[str, list[str]] = {}
    for path in raw:
        by_block.setdefault(_block_id(path), []).append(path)

    ranks: dict[str, int] = {}
    masks: dict[str, np.ndarray] = {}
    for paths in by_block.values():
        # stacked leaves of one shape take the block minimum layer by layer;
        # leaves of different batch shapes share one scalar minimum
        per_leaf = [np.minimum(raw[p], r_max) for p in paths]
        if all(a.shape == per_leaf[0].shape for a in per_leaf):
            block_min = np.minimum.reduce(per_leaf)
        else:
            block_min = np.full((1,), min(int(a.min()) for a in per_leaf))
        for p in paths:
            leaf_shape = shapes[p]
            batch = leaf_shape[:-2]
            vals = block_min
            if vals.shape != batch:
                vals = np.broadcast_to(np.min(vals), batch if batch else (1,))
            r_static = max(1, int(vals.max()))
            r_static = min(r_static, leaf_shape[-2], leaf_shape[-1])
            ranks[p] = r_static
            if batch and vals.size > 1 and (vals.min() != vals.max()):
                idx = np.arange(r_static)[None, :]
                flat_vals = vals.reshape(-1)[:, None]
                mask = (idx < flat_vals).astype(np.float32)
                masks[p] = mask.reshape(batch + (r_static,))
    return ranks, masks
