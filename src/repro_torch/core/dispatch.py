"""Compute dispatch: the one place that picks a lowering for the ZO leaf
ops, the forward attention and the selective scan (counterpart of
``repro.core.dispatch``).

There is no knob: the tensor's device decides.  On a CUDA tensor each
kernel-backed op launches its hand-written kernel (or the wrapper raises —
there is no ``try`` and no fallback).  On a CPU tensor each runs the plain
version, which is the reference's XLA path op for op; prefill additionally
keeps the reference's rule of materialized full attention below
``chunked_min_seq`` on the CPU.  On the card, prefill always goes through
the flash kernel.

ZO leaf ops.  A TeZO-family low-rank leaf takes ``kernels.tezo_perturb``
(perturb, bridge, chain, the SGD update) or ``kernels.tezo_adam`` (the Adam
update); a LOZO low-rank leaf takes ``kernels.tezo_perturb`` with τ ≡ 1
through ``lozo_chain_k``, and a SubZO one ``kernels.subzo_perturb``, for
every pass including the update (its restore chained before it).  Every
other leaf takes the dense-noise ops: a leaf the noise
kernels cover (:func:`noise_kernel_eligible`, the reference's rule) draws
its z from the counter stream of ``(key_t, path)`` on
``kernels.zo_noise.noise_perturb`` / ``noise_update``; any other (a norm
scale of one dim, a stack of fewer than 8 rows) takes the reference's jnp
branch in plain PyTorch on either device, over the ``jax.random`` z the step
drew on the host (``core.estimator.StepNoise``).  All of them write the
leaf in place unless ``out`` names another buffer (the ``exact`` restore
mode), and every chained op replays the rounding of the separate passes it
merges, so chained and unchained schedules agree bit for bit.

Sharded leaves.  Under a shard context (``utils.shard_ctx``) a leaf is this
rank's shard: eligibility is decided on the whole leaf's shape, the noise
kernels get the shard's global offsets (the reference's
``_global_offsets``), and the low-rank ops get the shard and the matching
factor rows from the estimator.

Quantized leaves (``core.quant.QuantLeaf``).  Every leaf op takes a
QuantLeaf wherever it takes a dense leaf and branches on the leaf kind
first.  The TeZO-family ops close the delta in τ-space, ``acc +=
scale·τ`` through the same ``add_scaled`` per delta, so no weight-sized
byte moves on any pass and chained == unchained holds bitwise; TeZO-Adam
applies its preconditioner in τ-space (``τ_m·rsqrt(τ_v + ε)``), the
reference's documented deviation from the dense leaf's Eq.-8
reconstruction.  The MeZO-family ops run on the leaf's dense ``nacc``
buffer under the leaf's own path (the noise kernels where it is eligible),
so the counter streams are the dense run's.  The new ``acc`` is a new
tensor (r floats per layer) and the leaf a new QuantLeaf; ``nacc`` is
written in place unless ``out`` names its buffer.  Weight decay is
rejected.  The forward half is :func:`quant_matmul_fwd`.
"""

from __future__ import annotations

import torch

from repro_torch.core.cpd import CPDFactor, is_lowrank_leaf
from repro_torch.core.quant import QuantLeaf, dequantize, scaled_lut
from repro_torch.kernels import zo_noise
from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                  paged_verify_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.tezo_adam import tezo_adam_update
from repro_torch.kernels.subzo_perturb import subzo_perturb
from repro_torch.kernels.tezo_perturb import add_scaled, lozo_chain_k, tezo_perturb
from repro_torch.utils import shard_ctx


def attention_fwd(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, T, KV, dh]
    v: torch.Tensor,  # [B, T, KV, dh]
    *,
    window: int = 0,
    q_offset: int = 0,
    chunked_min_seq: int = 8192,
) -> torch.Tensor:
    """Causal (GQA, sliding-window when ``window`` > 0) prefill attention
    for one block."""
    if q.device.type == "cpu" and q.shape[1] < chunked_min_seq:
        from repro_torch.models import layers  # lazy: layers imports this module

        return layers.full_attention(q, k, v, window=window, q_offset=q_offset)
    return flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)


def decode_attention_fwd(
    q: torch.Tensor,  # [S, H, dh] one query token per decode slot
    k_pages: torch.Tensor,  # [n_pages, page_size, KV, dh] shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_slot] int32 physical page ids
    lengths: torch.Tensor,  # [S] int32 valid kv length per slot
) -> torch.Tensor:
    """Paged (block-table) KV-cache decode attention for one step."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, lengths)


def verify_attention_fwd(
    q: torch.Tensor,  # [S, T, H, dh] the draft window per decode slot
    k_pages: torch.Tensor,  # [n_pages, page_size, KV, dh] shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_slot] int32 physical page ids
    lengths: torch.Tensor,  # [S] int32; window position t attends kpos < lengths + t
) -> torch.Tensor:
    """Paged multi-token speculative-verify attention for one verify step:
    the T-token generalization of :func:`decode_attention_fwd`, on the same
    kernel (at T = 1 bitwise the decode path)."""
    return paged_verify_attention(q, k_pages, v_pages, block_tables, lengths)


def selective_scan_fwd(
    x: torch.Tensor,  # [B, S, D]
    dt: torch.Tensor,  # [B, S, D] (softplus'd)
    a: torch.Tensor,  # [D, N] (negative)
    b: torch.Tensor,  # [B, S, N]
    c: torch.Tensor,  # [B, S, N]
    h0: torch.Tensor,  # [B, D, N] f32
) -> tuple:
    """Mamba-1 selective scan for one block: (y [B,S,D] f32, h_last).  The
    caller adds the D∘x skip.  On the card the kernel runs at every S: the
    reference sends S == 1 (a decode step) to its sequential XLA cell, as a
    one-step TPU launch buys nothing, but here one launch replaces the
    plain version's per-step elementwise launches."""
    return selective_scan(x, dt, a, b, c, h0)


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
# the QuantLeaf protocol
# ---------------------------------------------------------------------------


def _quant_no_decay(decay) -> None:
    if decay is not None:
        raise ValueError(
            "weight decay is unsupported on quantized leaves (it scales the "
            "frozen packed base) — quant.validate_quant_config rejects this "
            "at build time"
        )


def _quant_nacc(w: QuantLeaf) -> torch.Tensor:
    if w.nacc is None:
        raise ValueError(
            "dense-noise op on a QuantLeaf without a noise buffer: "
            "quantize with with_nacc=True (MeZO-family methods) — "
            "see core.quant.quantize_for_config"
        )
    return w.nacc


def _quant_acc_chain(w: QuantLeaf, taus, scales, decay=None) -> QuantLeaf:
    """``acc += scaleᵢ·τᵢ`` in chain order, one ``add_scaled`` rounding per
    delta, so the grouping of the deltas never changes the result."""
    _quant_no_decay(decay)
    acc = w.acc
    for tau, s in zip(taus, scales):
        acc = add_scaled(acc, tau, s)
    return w.replace(acc=acc)


def _on_nacc(w: QuantLeaf, res) -> QuantLeaf | tuple:
    """Rewrap a dense-noise op's result on ``nacc``: its W (alone, or first
    of a tuple with the moments) becomes the leaf's new ``nacc``."""
    if isinstance(res, tuple):
        return (w.replace(nacc=res[0]),) + res[1:]
    return w.replace(nacc=res)


# ---------------------------------------------------------------------------
# TeZO-family leaf ops (factors and τ on the leaf's device)
# ---------------------------------------------------------------------------


def perturb_chain_leaf(w, factor: CPDFactor, taus, scales, *, out=None):
    """scalesᵢ·recon(τᵢ) in chain order, in one pass for one low-rank leaf:
    the perturb (one delta), the bridge (two) or a longer chain, bitwise
    the single-delta passes.  A QuantLeaf adds the deltas to ``acc``."""
    if isinstance(w, QuantLeaf):
        return _quant_acc_chain(w, list(taus), list(scales))
    return tezo_perturb(w, factor.u, factor.v, torch.stack(list(taus), dim=-2),
                        list(scales), out=out)


def _restore_chain(restore, restore_scale):
    """(operand list, scale list) of a restore (τ vectors or probe ids): a
    list/tuple is a chain, anything else one delta."""
    if restore is None:
        return [], []
    if isinstance(restore, (list, tuple)):
        return list(restore), list(restore_scale)
    return [restore], [restore_scale]


def sgd_update_leaf(w, factor: CPDFactor, ktau, lr, *, decay=None, restore_tau=None,
                    restore_scale=0.0, out=None):
    """W ← decay·W − lr·recon(ktau) (TeZO / TeZO-m), with the chained
    restore deltas first in the same pass.  ``lr`` is a host float.  A
    QuantLeaf adds the restore deltas and −lr·ktau to ``acc``."""
    taus, scales = _restore_chain(restore_tau, restore_scale)
    if isinstance(w, QuantLeaf):
        return _quant_acc_chain(w, taus + [ktau], scales + [-float(lr)], decay)
    return tezo_perturb(w, factor.u, factor.v, torch.stack(taus + [ktau], dim=-2),
                        scales + [-float(lr)], decay=decay, out=out)


def adam_update_leaf(w, factor: CPDFactor, tau_m, tau_v, lr, eps, *, decay=None,
                     restore_tau=None, restore_scale=0.0, out=None):
    """W ← decay·W − lr·M/√(V+ε) with M, V reconstructed from the τ-space
    moments (Eq. 8), the chained restore deltas first in the same pass.  A
    QuantLeaf adds the restore deltas, then −lr·τ_m·rsqrt(τ_v + ε), to
    ``acc`` (the factorwise preconditioner)."""
    taus, scales = _restore_chain(restore_tau, restore_scale)
    if isinstance(w, QuantLeaf):
        upd = tau_m.float() * torch.rsqrt(tau_v.float() + eps)
        return _quant_acc_chain(w, taus + [upd], scales + [-float(lr)], decay)
    tau_r = torch.stack(taus, dim=-2) if taus else None
    return tezo_adam_update(w, factor.u, factor.v, tau_m, tau_v, lr, eps, decay=decay,
                            tau_r=tau_r, restore_scale=scales, out=out)


# ---------------------------------------------------------------------------
# LOZO / SubZO update ops (the window's factors on the leaf's device; their
# perturb chains call lozo_chain_k and subzo_perturb from the estimator)
# ---------------------------------------------------------------------------


def lozo_update_leaf(w, u, kv, lr, *, decay=None, restore_v=None, restore_scale=0.0,
                     out=None):
    """W ← decay·W − lr·U·kvᵀ, ``kv`` the probe mean κ·V (or LOZO-m's
    momentum), with the chained restore deltas first in the same pass and
    the decay on the update delta only."""
    vs, scales = _restore_chain(restore_v, restore_scale)
    return lozo_chain_k(w, u, vs + [kv], scales + [-float(lr)], decay=decay, out=out)


def subzo_update_leaf(w, u, v, sbar, lr, *, decay=None, restore_sigma=None,
                      restore_scale=0.0, out=None):
    """W ← decay·W − lr·U·Σ̄·Vᵀ, Σ̄ the probe mean κ·Σ, with the chained
    restore deltas first in the same pass and the decay on the last."""
    sigmas, scales = _restore_chain(restore_sigma, restore_scale)
    return subzo_perturb(w, u, v, torch.stack(sigmas + [sbar], dim=-3),
                         scales + [-float(lr)], decay=decay, out=out)


# ---------------------------------------------------------------------------
# dense-noise leaf ops (MeZO family + every method's dense-fallback leaves)
# ---------------------------------------------------------------------------


def noise_kernel_eligible(w) -> bool:
    """Can this leaf's dense N(0, 1) perturbation run on the noise kernels?
    Two trailing matrix dims >= 8 (``cpd.is_lowrank_leaf``) and rows below
    2^24 (the row shares a counter word with the probe id), as the
    reference decides, so a leaf's noise stream is the same for every pass
    and every method."""
    return is_lowrank_leaf("", w) and w.shape[-2] < zo_noise.MAX_ROWS


def _write(res, w, out):
    out = w if out is None else out
    return out.copy_(res)


def _dense_chain(w, probes, scales, dense_z):
    """scalesᵢ·z_pᵢ over pre-drawn z, one ``add_scaled`` rounding each."""
    for p, s in zip(probes, scales):
        w = add_scaled(w, dense_z(p), s)
    return w


def noise_perturb_chain_leaf(w, key_t, path, probes, scales, dense_z, *, out=None):
    """scalesᵢ·z_pᵢ in chain order for one leaf, in one pass: the perturb
    (one probe), the bridge (restore probe i, perturb probe i+1) or a
    longer chain.  An eligible leaf draws z from the counter stream of
    ``(key_t, path)`` on the noise kernel; any other adds the step's
    pre-drawn ``jax.random`` z, ``dense_z(probe)``, as the reference's jnp
    branch does.  A QuantLeaf runs the chain on its ``nacc``."""
    if isinstance(w, QuantLeaf):
        return _on_nacc(w, noise_perturb_chain_leaf(_quant_nacc(w), key_t, path, probes,
                                                    scales, dense_z, out=out))
    if noise_kernel_eligible(shard_ctx.view(path, w)):
        return zo_noise.noise_perturb(w, zo_noise.leaf_seed(key_t, path), probes, scales,
                                      out=out, offsets=shard_ctx.leaf_offsets(path, w))
    return _write(_dense_chain(w, probes, scales, dense_z), w, out)


def _decayed(w, decay):
    wf = w.float()
    return wf if decay is None else wf * decay


def _noise_update(variant, w, m_buf, v_buf, key_t, path, kappas, lr, beta1, beta2, eps,
                  dense_z, decay, restore_probe, restore_scale):
    """One leaf's update: the noise kernel (W, M and V in place) on an
    eligible leaf, else the reference's jnp branch over pre-drawn z (new
    tensors); a QuantLeaf's on its ``nacc``.  Returns ``(w,)``, ``(w, m)``
    or ``(w, m, v)``."""
    if isinstance(w, QuantLeaf):
        _quant_no_decay(decay)
        return _on_nacc(w, _noise_update(variant, _quant_nacc(w), m_buf, v_buf, key_t, path,
                                         kappas, lr, beta1, beta2, eps, dense_z, None,
                                         restore_probe, restore_scale))
    probes, scales = _restore_chain(restore_probe, restore_scale)
    if noise_kernel_eligible(shard_ctx.view(path, w)):
        return zo_noise.noise_update(
            w, zo_noise.leaf_seed(key_t, path), kappas, variant, lr, beta1, beta2, eps,
            decay=decay, m_buf=m_buf, v_buf=v_buf, restore_probes=probes,
            restore_scales=scales, offsets=shard_ctx.leaf_offsets(path, w))
    res = _dense_chain(w, probes, scales, dense_z)
    g = kappa_fold(kappas, [dense_z(i).float() for i in range(kappas.shape[0])])
    if variant == "sgd":
        return (_write((_decayed(res, decay) - lr * g).to(w.dtype), w, None),)
    m_new = beta1 * m_buf + (1.0 - beta1) * g
    if variant == "momentum":
        return _write((_decayed(res, decay) - lr * m_new).to(w.dtype), w, None), m_new
    v_new = beta2 * v_buf + (1.0 - beta2) * g * g
    upd = m_new * torch.rsqrt(v_new + eps)
    return _write((_decayed(res, decay) - lr * upd).to(w.dtype), w, None), m_new, v_new


def noise_sgd_update_leaf(w, key_t, path, kappas, lr, dense_z, *, decay=None,
                          restore_probe=None, restore_scale=0.0):
    """W ← decay·W − lr·mean_i κ_i z_i for one leaf, the chained restore
    deltas first in the same pass."""
    return _noise_update("sgd", w, None, None, key_t, path, kappas, lr, 0.0, 0.0, 0.0,
                         dense_z, decay, restore_probe, restore_scale)[0]


def noise_momentum_update_leaf(w, m_buf, key_t, path, kappas, lr, beta1, dense_z, *,
                               decay=None, restore_probe=None, restore_scale=0.0):
    """M ← β₁M + (1−β₁)g; W ← decay·W − lr·M.  Returns (w', m')."""
    return _noise_update("momentum", w, m_buf, None, key_t, path, kappas, lr, beta1, 0.0, 0.0,
                         dense_z, decay, restore_probe, restore_scale)


def noise_adam_update_leaf(w, m_buf, v_buf, key_t, path, kappas, lr, beta1, beta2, eps,
                           dense_z, *, decay=None, restore_probe=None, restore_scale=0.0):
    """Dense Adam step; returns (w', m', v')."""
    return _noise_update("adam", w, m_buf, v_buf, key_t, path, kappas, lr, beta1, beta2, eps,
                         dense_z, decay, restore_probe, restore_scale)


# ---------------------------------------------------------------------------
# the QuantLeaf forward
# ---------------------------------------------------------------------------


def _quant_matmul_ref(x: torch.Tensor, w: QuantLeaf) -> torch.Tensor:
    """Port of the reference's XLA gather twin of the quantized forward:
    dequantize in the leaf's dtype by a gather, contract densely in f32,
    add the temporal-factor delta (and ``nacc``).  The tests hold the
    forward against it; nothing on the model path calls it."""
    xf = x.float()
    out = torch.matmul(xf, dequantize(w).float())
    ut = w.qu * w.acc[..., None, :]
    out = out + torch.matmul(torch.matmul(xf, ut), w.qv.transpose(-1, -2))
    if w.nacc is not None:
        out = out + torch.matmul(xf, w.nacc.float())
    return out.to(x.dtype)


def quant_matmul_fwd(x: torch.Tensor, w: QuantLeaf) -> torch.Tensor:
    """``x @ W_eff`` for one layer's quantized leaf (``codes`` [Kw, N]), the
    forward half of the QuantLeaf protocol (models call it through
    ``layers.weight_matmul``).  ``W_eff = dequant(codes) + qu·diag(acc)·qvᵀ
    [+ nacc]`` is never materialized: ``kernels.quant_matmul`` reads the
    packed codes, dequantizes a tile through the scaled LUT and adds
    ``xu @ qvᵀ``, with ``xu = x @ (qu·acc)`` (an [M, r] product) formed here
    first.  The MeZO family's ``nacc`` delta is a separate f32 product on
    both devices, as in the reference (state traffic, not weight
    materialization)."""
    if w.codes.dim() != 2:
        raise ValueError(f"quant_matmul_fwd takes one layer's leaf; got codes "
                         f"{tuple(w.codes.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xf = x2.float()
    xu = torch.matmul(xf, w.qu * w.acc[None, :])
    out = quant_matmul(x2.contiguous(), w.codes, scaled_lut(w), xu, w.qv, bits=w.bits)
    if w.nacc is not None:
        out = (out.float() + torch.matmul(xf, w.nacc.float())).to(x.dtype)
    return out.reshape(lead + (out.shape[-1],))
