"""Fused TeZO-Adam update: the hand-written CUDA kernel and its plain
PyTorch version.

Optional restore deltas ``scale_i·(u·diag(τ_r,i))·vᵀ`` (each rounded to W's
dtype, exactly as a ``tezo_perturb`` chain), then

    W ← round_W(decay·W − lr·M/√(V+ε)),
    M = (u·diag(τ_M))·vᵀ,   V = ((u∘u)·diag(τ_V))·(v∘v)ᵀ      (paper Eq. 8).

Replaces the TPU kernel ``repro/kernels/tezo_adam.py::tezo_adam_update``
(through ``repro.kernels.ops.tezo_adam_update``).  The kernel is
``csrc/tezo_adam.cu``: the tiling and the shared-memory weight stream of
``csrc/tezo_perturb.cu``, whose staging, sums and rounding it runs for the
restore, then M and V summed in one sweep from one staging of u and v per
32 rank columns; neither reaches device memory.  Shapes: W ``[..., m, n]``, u ``[..., m, r]``,
v ``[..., n, r]``, τ_M and τ_V ``[..., r]``, τ_r ``[..., k, r]`` (all f32);
``lr``, ``eps``, ``decay`` and the restore scales are host floats.  It writes
in place unless ``out`` names another buffer.

On a CPU tensor :func:`tezo_adam_update` runs :func:`tezo_adam_update_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.cpd import CPDFactor, reconstruct, reconstruct_squared
from repro_torch.kernels import _build
from repro_torch.kernels.tezo_perturb import _DTYPES, _check_out, add_scaled, check_factors


def tezo_adam_update_plain(w, u, v, tau_m, tau_v, lr, eps, decay=None, tau_r=None,
                           restore_scale=(), out=None):
    """The kernel's function in plain PyTorch: the restore deltas as
    ``add_scaled`` passes, then M and V by ``torch.matmul`` and one
    ``add_scaled(w, M·rsqrt(V + ε), −lr, decay)``."""
    factor = CPDFactor(u, v)
    res = w
    if tau_r is not None:
        for i, rs in enumerate(restore_scale):
            res = add_scaled(res, reconstruct(factor, tau_r[..., i, :]), rs)
    m = reconstruct(factor, tau_m)
    vv = reconstruct_squared(factor, tau_v)
    res = add_scaled(res, m * torch.rsqrt(vv + eps), -lr, decay)
    out = w if out is None else out
    return out.copy_(res)


def tezo_adam_update(w, u, v, tau_m, tau_v, lr, eps, decay=None, tau_r=None,
                     restore_scale=(), out=None):
    """The Adam pass over one leaf (in place, or into ``out``); returns it."""
    restore_scale = tuple(restore_scale) if tau_r is not None else ()
    _build.check_chain(len(restore_scale))
    if w.device.type == "cpu":
        return tezo_adam_update_plain(w, u, v, tau_m, tau_v, lr, eps, decay=decay,
                                      tau_r=tau_r, restore_scale=restore_scale, out=out)
    if w.device.type != "cuda":
        raise ValueError(f"tezo_adam_update runs on cuda or cpu, not {w.device}")
    taus = (tau_m, tau_v) + (() if tau_r is None else (tau_r,))
    B, m, n, r = check_factors(w, u, v, *taus)
    batch = tuple(w.shape[:-2])
    if tuple(tau_m.shape) != (*batch, r) or tuple(tau_v.shape) != (*batch, r):
        raise ValueError(f"tau_m {tuple(tau_m.shape)} / tau_v {tuple(tau_v.shape)} must "
                         f"be [..., {r}] for W {tuple(w.shape)}")
    k = len(restore_scale)
    if tau_r is not None and tuple(tau_r.shape) != (*batch, k, r):
        raise ValueError(f"tau_r {tuple(tau_r.shape)} must be [..., {k}, {r}]")
    out = _check_out(w, out)
    restore = _build.DeltaChain.of(restore_scale, [1.0] * k)
    lib = _build.load()
    with torch.cuda.device(w.device):
        err = lib.tezo_adam_update_fwd(
            w.data_ptr(), out.data_ptr(), u.data_ptr(), v.data_ptr(), tau_m.data_ptr(),
            tau_v.data_ptr(), None if tau_r is None else tau_r.data_ptr(), restore,
            -float(lr), float(eps), 1.0 if decay is None else float(decay),
            B, m, n, r, _DTYPES[w.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "tezo_adam_update_fwd")
    tezo_adam_update.launches += 1
    return out


tezo_adam_update.launches = 0
