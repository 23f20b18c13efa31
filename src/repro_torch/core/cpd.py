"""CPD factors for TeZO perturbations (counterpart of ``repro.core.cpd``).

The whole history of ZO perturbations of a weight ``W ∈ R^{m×n}`` is a CP
decomposition ``Z_t = Σ_s τ_{t,s}·(u_s ∘ v_s)``: the factors ``u [m, r]``,
``v [n, r]`` are drawn once and frozen, and only ``τ_t ∈ R^r`` is drawn per
step and probe.  A leaf ``[..., m, n]`` is a batch of independent matrices:
its factors carry the same leading dims and each batch element draws its
own τ.

Every draw replays the reference's stream (``utils.jax_random``): factors
from ``fold_in_path(key, path + "#u"/"#v")``, τ from
``fold_in_path(fold_in(key_t, probe), path + "#tau")``, a dense leaf's noise
from ``path + "#dense"``.  A quantized leaf (``core.quant.QuantLeaf``)
carries its own frozen factors, drawn at quantize time from the same
streams.  Per-layer rank masks (spectral rank) are not ported yet
(ROADMAP.md Queue A).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core.quant import QuantLeaf
from repro_torch.utils import jax_random
from repro_torch.utils.tree import fold_in_path, map_with_path


@dataclass
class CPDFactor:
    """Frozen model-dimension factors of one leaf: u (..., m, r), v (..., n, r)."""

    u: torch.Tensor
    v: torch.Tensor

    @property
    def rank(self) -> int:
        return self.u.shape[-1]

    @property
    def batch(self) -> tuple:
        return tuple(self.u.shape[:-2])


FactorTree = dict  # {leaf_path: CPDFactor} over the low-rank leaves


def is_lowrank_leaf(path: str, leaf: Any, min_dim: int = 8) -> bool:
    """A leaf is low-rank-perturbed iff its trailing two dims are both real
    matrix dims; norm scales, biases and degenerate matrices fall back to a
    dense perturbation."""
    if leaf.ndim < 2:
        return False
    m, n = leaf.shape[-2], leaf.shape[-1]
    return m >= min_dim and n >= min_dim


def _leaf_rank(path: str, leaf: Any, ranks: Optional[dict], default_rank: int) -> int:
    """The static rank of a leaf: a per-path override, else the default,
    always capped by min(m, n)."""
    r = default_rank
    if isinstance(ranks, dict) and path in ranks:
        r = int(ranks[path])
    m, n = leaf.shape[-2], leaf.shape[-1]
    return max(1, min(r, m, n))


def init_factors(
    params: Any,
    key,
    default_rank: int = 64,
    ranks: Optional[dict] = None,
) -> FactorTree:
    """Draw the frozen N(0, 1) f32 factors of every low-rank leaf, on the
    leaf's device.  A QuantLeaf's factors are its own ``qu``/``qv`` (the
    same tensors: nothing writes them), drawn from the same streams at its
    rank."""
    factors: FactorTree = {}

    def make(path: str, leaf: torch.Tensor) -> torch.Tensor:
        if isinstance(leaf, QuantLeaf):
            factors[path] = CPDFactor(u=leaf.qu, v=leaf.qv)
        elif is_lowrank_leaf(path, leaf):
            r = _leaf_rank(path, leaf, ranks, default_rank)
            batch, (m, n) = tuple(leaf.shape[:-2]), leaf.shape[-2:]
            factors[path] = CPDFactor(
                u=jax_random.normal(fold_in_path(key, path + "#u"), batch + (m, r), leaf.device),
                v=jax_random.normal(fold_in_path(key, path + "#v"), batch + (n, r), leaf.device),
            )
        return leaf

    map_with_path(make, params)
    return factors


def tau_key(key_t, path: str, probe: int = 0) -> tuple[int, int]:
    """The key of a leaf's τ draw at one step and probe."""
    return fold_in_path(jax_random.fold_in(key_t, probe), path + "#tau")


def dense_key(key_t, path: str, probe: int = 0) -> tuple[int, int]:
    """The key of a dense leaf's noise draw at one step and probe."""
    return fold_in_path(jax_random.fold_in(key_t, probe), path + "#dense")


def sample_tau(factor: CPDFactor, key_t, path: str, probe: int = 0) -> torch.Tensor:
    """τ ~ N(0, I_r) for one leaf at one step and probe: f32 (..., r) on the
    host.  The step draws all of these at once (``core.estimator``); this is
    the one-leaf form."""
    return jax_random.normal(tau_key(key_t, path, probe), factor.batch + (factor.rank,))


def reconstruct(factor: CPDFactor, tau: torch.Tensor) -> torch.Tensor:
    """Z = (u·diag(τ))·vᵀ in f32, batched over the leading dims."""
    ut = factor.u * tau[..., None, :].to(factor.u.dtype)
    return torch.matmul(ut, factor.v.transpose(-1, -2))


def reconstruct_squared(factor: CPDFactor, tau_sq: torch.Tensor) -> torch.Tensor:
    """The separable second moment (paper Eq. 8): Σ_s (τ_V)_s (u_s² ∘ v_s²),
    as ``((u*u)·diag(τ_V))·(v*v)ᵀ``."""
    u2 = factor.u * factor.u
    v2 = factor.v * factor.v
    ut = u2 * tau_sq[..., None, :].to(u2.dtype)
    return torch.matmul(ut, v2.transpose(-1, -2))


def dense_noise(leaf: torch.Tensor, key_t, path: str, probe: int = 0) -> torch.Tensor:
    """Dense z ~ N(0, I) for a non-low-rank leaf, drawn in f32 on the host
    and cast to the leaf dtype."""
    z = jax_random.normal(dense_key(key_t, path, probe), leaf.shape)
    return z.to(leaf.dtype)
