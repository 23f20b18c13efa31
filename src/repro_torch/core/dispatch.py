"""Compute dispatch: the one place that picks a lowering for the ZO leaf
ops and the forward attention (counterpart of ``repro.core.dispatch``).

There is no knob: the tensor's device decides.  On a CUDA tensor each
kernel-backed op launches its hand-written kernel (or the wrapper raises —
there is no ``try`` and no fallback).  On a CPU tensor each runs the plain
version, which is the reference's XLA path op for op; prefill additionally
keeps the reference's rule of materialized full attention below
``chunked_min_seq`` on the CPU.  On the card, prefill always goes through
the flash kernel.

ZO leaf ops.  A TeZO-family low-rank leaf takes ``kernels.tezo_perturb``
(perturb, bridge, chain, the SGD update) or ``kernels.tezo_adam`` (the Adam
update); both write the leaf in place unless ``out`` names another buffer
(the ``exact`` restore mode).  Every chained op replays the rounding of the
separate passes it merges, so chained and unchained schedules agree bit for
bit.  Dense leaves (norm scales, biases: what ``cpd.is_lowrank_leaf``
rejects) take the reference's jnp branch in plain PyTorch on either device;
on the TeZO path no dense leaf is eligible for the reference's noise
kernels, whose port waits in ROADMAP.md Queue B.  Where the reference draws
a dense leaf's z from its key inside the op, these ops take the step's
pre-drawn z (``core.estimator.StepNoise``).
"""

from __future__ import annotations

import torch

from repro_torch.core.cpd import CPDFactor
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.tezo_adam import tezo_adam_update
from repro_torch.kernels.tezo_perturb import add_scaled, tezo_perturb


def attention_fwd(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, T, KV, dh]
    v: torch.Tensor,  # [B, T, KV, dh]
    *,
    q_offset: int = 0,
    chunked_min_seq: int = 8192,
) -> torch.Tensor:
    """Causal (GQA) prefill attention for one block."""
    if q.device.type == "cpu" and q.shape[1] < chunked_min_seq:
        from repro_torch.models import layers  # lazy: layers imports this module

        return layers.full_attention(q, k, v, q_offset=q_offset)
    return flash_attention(q, k, v, causal=True, q_offset=q_offset)


def decode_attention_fwd(
    q: torch.Tensor,  # [S, H, dh] one query token per decode slot
    k_pages: torch.Tensor,  # [n_pages, page_size, KV, dh] shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_slot] int32 physical page ids
    lengths: torch.Tensor,  # [S] int32 valid kv length per slot
) -> torch.Tensor:
    """Paged (block-table) KV-cache decode attention for one step."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, lengths)


# ---------------------------------------------------------------------------
# the probe-mean fold
# ---------------------------------------------------------------------------


def kappa_fold(kappas: torch.Tensor, terms, *, square: bool = False) -> torch.Tensor:
    """mean_i κ_i·term_i (``square``: mean_i (κ_i·κ_i)·(term_i·term_i)) as a
    left fold in probe order, then one divide by q — the arithmetic of the
    reference's ``fence.kappa_fold``, without its XLA:CPU fence (eager
    PyTorch rounds every op on its own already)."""
    acc = None
    for i, t in enumerate(terms):
        k = kappas[i]
        d = (k * k) * (t * t) if square else k * t
        acc = d if acc is None else acc + d
    return acc / len(terms)


# ---------------------------------------------------------------------------
# TeZO-family leaf ops (factors and τ on the leaf's device)
# ---------------------------------------------------------------------------


def perturb_leaf(w, factor: CPDFactor, tau, scale, *, out=None):
    """W + scale·(u·diag(τ))·vᵀ for one low-rank leaf; τ is [..., r]."""
    return tezo_perturb(w, factor.u, factor.v, tau.unsqueeze(-2), [scale], out=out)


def perturb_pair_leaf(w, factor: CPDFactor, tau_a, tau_b, scale_a, scale_b, *, out=None):
    """The bridge: scale_a·recon(τ_a) then scale_b·recon(τ_b) in one pass,
    bitwise two ``perturb_leaf`` passes."""
    taus = torch.stack([tau_a, tau_b], dim=-2)
    return tezo_perturb(w, factor.u, factor.v, taus, [scale_a, scale_b], out=out)


def perturb_chain_leaf(w, factor: CPDFactor, taus, scales, *, out=None):
    """scalesᵢ·recon(τᵢ) in chain order, in one pass."""
    return tezo_perturb(w, factor.u, factor.v, torch.stack(list(taus), dim=-2),
                        list(scales), out=out)


def _restore_chain(restore_tau, restore_scale):
    """(τ list, scale list) of a restore operand: a list/tuple is a chain,
    anything else one delta."""
    if restore_tau is None:
        return [], []
    if isinstance(restore_tau, (list, tuple)):
        return list(restore_tau), list(restore_scale)
    return [restore_tau], [restore_scale]


def sgd_update_leaf(w, factor: CPDFactor, ktau, lr, *, decay=None, restore_tau=None,
                    restore_scale=0.0, out=None):
    """W ← decay·W − lr·recon(ktau) (TeZO / TeZO-m), with the chained
    restore deltas first in the same pass.  ``lr`` is a host float."""
    taus, scales = _restore_chain(restore_tau, restore_scale)
    return tezo_perturb(w, factor.u, factor.v, torch.stack(taus + [ktau], dim=-2),
                        scales + [-float(lr)], decay=decay, out=out)


def adam_update_leaf(w, factor: CPDFactor, tau_m, tau_v, lr, eps, *, decay=None,
                     restore_tau=None, restore_scale=0.0, out=None):
    """W ← decay·W − lr·M/√(V+ε) with M, V reconstructed from the τ-space
    moments (Eq. 8), the chained restore deltas first in the same pass."""
    taus, scales = _restore_chain(restore_tau, restore_scale)
    tau_r = torch.stack(taus, dim=-2) if taus else None
    return tezo_adam_update(w, factor.u, factor.v, tau_m, tau_v, lr, eps, decay=decay,
                            tau_r=tau_r, restore_scale=scales, out=out)


# ---------------------------------------------------------------------------
# dense-noise leaf ops (the reference's jnp branch; z pre-drawn per probe)
# ---------------------------------------------------------------------------


def _write(res, w, out):
    out = w if out is None else out
    return out.copy_(res)


def noise_perturb_leaf(w, z, scale, *, out=None):
    """W + scale·z for one dense leaf; z in the leaf dtype."""
    return _write(add_scaled(w, z, scale), w, out)


def noise_perturb_pair_leaf(w, z_a, scale_a, z_b, scale_b, *, out=None):
    """Restore probe a and perturb probe b: two ``add_scaled`` deltas."""
    return _write(add_scaled(add_scaled(w, z_a, scale_a), z_b, scale_b), w, out)


def noise_perturb_chain_leaf(w, zs, scales, *, out=None):
    res = w
    for z, s in zip(zs, scales):
        res = add_scaled(res, z, s)
    return _write(res, w, out)


def _noise_restored(w, restore_z, restore_scale):
    res = w
    for z, s in zip(*_restore_chain(restore_z, restore_scale)):
        res = add_scaled(res, z, s)
    return res


def _decayed(w, decay):
    wf = w.float()
    return wf if decay is None else wf * decay


def noise_sgd_update_leaf(w, zs, kappas, lr, *, decay=None, restore_z=None,
                          restore_scale=0.0, out=None):
    """W ← decay·W − lr·mean_i κ_i z_i for one dense leaf; ``zs`` holds every
    probe's z, ``restore_z`` the chained restore's."""
    res = _noise_restored(w, restore_z, restore_scale)
    g = kappa_fold(kappas, [z.float() for z in zs])
    return _write((_decayed(res, decay) - lr * g).to(w.dtype), w, out)


def noise_momentum_update_leaf(w, m_buf, zs, kappas, lr, beta1, *, decay=None,
                               restore_z=None, restore_scale=0.0, out=None):
    """Dense momentum step: M ← β₁M + (1−β₁)g; W ← decay·W − lr·M.
    Returns (w', m')."""
    res = _noise_restored(w, restore_z, restore_scale)
    g = kappa_fold(kappas, [z.float() for z in zs])
    m_new = beta1 * m_buf + (1.0 - beta1) * g
    return _write((_decayed(res, decay) - lr * m_new).to(w.dtype), w, out), m_new


def noise_adam_update_leaf(w, m_buf, v_buf, zs, kappas, lr, beta1, beta2, eps, *,
                           decay=None, restore_z=None, restore_scale=0.0, out=None):
    """Dense Adam step; returns (w', m', v')."""
    res = _noise_restored(w, restore_z, restore_scale)
    g = kappa_fold(kappas, [z.float() for z in zs])
    m_new = beta1 * m_buf + (1.0 - beta1) * g
    v_new = beta2 * v_buf + (1.0 - beta2) * g * g
    upd = m_new * torch.rsqrt(v_new + eps)
    return _write((_decayed(res, decay) - lr * upd).to(w.dtype), w, out), m_new, v_new
