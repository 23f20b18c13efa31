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
streams.

Per-layer ranks with static shapes (spectral rank, ``core.rank``): a stacked
leaf keeps one factor width r (its layers' largest) and a 0/1
``rank_mask`` ``(..., r)`` zeroes each layer's τ components past its own
rank.  τ is drawn on the host (``core.estimator.StepNoise``), so the mask
lives there too and multiplies the draw before it is copied to the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core.quant import QuantLeaf
from repro_torch.utils import jax_random, shard_ctx
from repro_torch.utils.tree import fold_in_path, map_with_path


@dataclass
class CPDFactor:
    """Frozen model-dimension factors of one leaf: u (..., m, r), v (..., n, r),
    and an optional per-layer ``rank_mask`` (..., r), f32 0/1 on the host."""

    u: torch.Tensor
    v: torch.Tensor
    rank_mask: Optional[torch.Tensor] = None

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
    rank_masks: Optional[dict] = None,
) -> FactorTree:
    """Draw the frozen N(0, 1) f32 factors of every low-rank leaf, on the
    leaf's device, with its ``rank_masks`` entry (shape (..., r)) as the
    factor's mask.  A QuantLeaf's factors are its own ``qu``/``qv`` (the
    same tensors: nothing writes them), drawn from the same streams at its
    rank; it takes no mask.  On a sharded state (``utils.shard_ctx``) a leaf
    is this rank's shard: its factors are drawn whole and cut, u by W's
    rows and v by its columns."""
    factors: FactorTree = {}

    def make(path: str, leaf: torch.Tensor) -> torch.Tensor:
        device = leaf.device
        leaf = shard_ctx.view(path, leaf)  # a shard's whole leaf: its draws whole, then cut
        if isinstance(leaf, QuantLeaf):
            if rank_masks is not None and path in rank_masks:
                raise ValueError(
                    f"rank_masks on quantized leaf {path}: per-layer rank "
                    "masks are unsupported with weight_quant"
                )
            factors[path] = CPDFactor(u=leaf.qu, v=leaf.qv)
        elif is_lowrank_leaf(path, leaf):
            r = _leaf_rank(path, leaf, ranks, default_rank)
            batch, (m, n) = tuple(leaf.shape[:-2]), leaf.shape[-2:]
            mask = None
            if rank_masks is not None and path in rank_masks:
                mask = torch.as_tensor(rank_masks[path], dtype=torch.float32, device="cpu")
                assert tuple(mask.shape) == batch + (r,), (
                    f"rank_mask for {path} must be {batch + (r,)}, got {tuple(mask.shape)}"
                )
            factors[path] = CPDFactor(
                u=shard_ctx.rows(path, jax_random.normal(fold_in_path(key, path + "#u"),
                                                         batch + (m, r), device)),
                v=shard_ctx.cols(path, jax_random.normal(fold_in_path(key, path + "#v"),
                                                         batch + (n, r), device)),
                rank_mask=mask,
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
    """τ ~ N(0, I_r) for one leaf at one step and probe, times its rank mask:
    f32 (..., r) on the host.  The step draws all of these at once
    (``core.estimator``); this is the one-leaf form."""
    tau = jax_random.normal(tau_key(key_t, path, probe), factor.batch + (factor.rank,))
    if factor.rank_mask is not None:
        tau = tau * factor.rank_mask
    return tau


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


def num_sampled_elements_per_step(params: Any, factors: FactorTree) -> int:
    """The fresh random scalars one optimization step draws, the quantity
    the paper's Table 2 compares (the reference's count): a low-rank leaf
    draws τ, r per batch element, any other leaf its every element."""
    count = 0

    def visit(path: str, leaf: Any) -> Any:
        nonlocal count
        if path in factors:
            count += math.prod(factors[path].batch) * factors[path].rank
        else:
            count += leaf.numel()
        return leaf

    map_with_path(visit, params)
    return count


def dense_noise(leaf: torch.Tensor, key_t, path: str, probe: int = 0) -> torch.Tensor:
    """Dense z ~ N(0, I) for a non-low-rank leaf, drawn in f32 on the host
    and cast to the leaf dtype."""
    z = jax_random.normal(dense_key(key_t, path, probe), leaf.shape)
    return z.to(leaf.dtype)
