"""TeZO perturbation chain: the hand-written CUDA kernel and its plain
PyTorch version.

For s = 0 .. k-1, ``W ← round_W(d_s·W + scale_s·(u·diag(τ_s))·vᵀ)``, with
``d_s = 1`` except ``decay`` on the last delta, each delta rounded to W's
dtype before the next one reads it.  One call covers a whole leaf
``[..., m, n]`` with factors ``u [..., m, r]``, ``v [..., n, r]`` and the
chain's ``taus [..., k, r]`` (f32); ``scales`` and ``decay`` are host
floats, so no step reads anything back from the device.

Replaces the TPU kernel ``repro/kernels/tezo_perturb.py::tezo_perturb``
(through ``repro.kernels.ops.tezo_perturb``).  The kernel is
``csrc/tezo_perturb.cu``: one launch per leaf over (column tiles, row
tiles, batch index).  A block's W tile arrives in shared memory by 16-byte
asynchronous copies while the factor columns are staged and each rank-r
delta is formed in registers, so Z never reaches device memory; the
deltas are applied to the shared tile and it goes back with 16-byte
stores.  It writes in place unless ``out`` names another buffer of W's
shape (the ``exact`` restore mode branches copies off the original weights
that way).

On a CPU tensor :func:`tezo_perturb` runs :func:`tezo_perturb_plain`; on a
CUDA tensor it launches the kernel or raises.

LOZO's ``W ← round_W(d_s·W + scale_s·U·V_sᵀ)`` chains run on the same
kernel (:func:`lozo_chain_k`, the reference's ``ops.lozo_chain_k``): U as
it is and the k V factors by pointer, each delta summing its own r
columns, so the chain is bitwise k single passes.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.cpd import CPDFactor, reconstruct
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def add_scaled(w: torch.Tensor, z: torch.Tensor, scale: float, decay=None) -> torch.Tensor:
    """``decay·w + scale·z`` formed in f32, each product and the sum rounded
    on its own, then cast to w's dtype — the reference's
    ``dispatch.add_scaled``.  ``decay`` None skips the multiply (≡ 1)."""
    wf = w.float()
    acc = wf if decay is None else wf * decay
    return (acc + z.float() * scale).to(w.dtype)


def _decays(k: int, decay) -> list:
    return [1.0] * (k - 1) + [1.0 if decay is None else float(decay)]


def tezo_perturb_plain(w, u, v, taus, scales, decay=None, out=None):
    """The kernel's function in plain PyTorch: one ``add_scaled`` over a
    ``torch.matmul`` reconstruction per delta."""
    factor = CPDFactor(u, v)
    k = len(scales)
    res = w
    for s in range(k):
        res = add_scaled(res, reconstruct(factor, taus[..., s, :]), scales[s],
                         decay if s == k - 1 else None)
    out = w if out is None else out
    return out.copy_(res)


def check_factors(w, u, v, *taus):
    """Validate a leaf and its f32 factors; returns (B, m, n, r)."""
    if w.dim() < 2:
        raise ValueError(f"a low-rank leaf has two matrix dims; got {tuple(w.shape)}")
    *batch, m, n = w.shape
    r = u.shape[-1]
    if tuple(u.shape) != (*batch, m, r) or tuple(v.shape) != (*batch, n, r):
        raise ValueError(f"factors u {tuple(u.shape)}, v {tuple(v.shape)} do not fit "
                         f"W {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"W must be f32 or bf16, not {w.dtype}")
    for name, t in (("w", w), ("u", u), ("v", v)) + tuple(("tau", t) for t in taus):
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, W on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "w" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be f32, not {t.dtype}")
    return math.prod(batch), m, n, r


def _check_out(w, out):
    if out is None:
        return w
    if out.shape != w.shape or out.dtype != w.dtype or out.device != w.device:
        raise ValueError("out must match W's shape, dtype and device")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    return out


def tezo_perturb(w, u, v, taus, scales, decay=None, out=None):
    """Apply the delta chain to ``w`` (in place, or into ``out``) and return
    the result.  ``taus`` is ``[..., k, r]`` f32 with ``len(scales) == k``."""
    if w.device.type == "cpu":
        return tezo_perturb_plain(w, u, v, taus, scales, decay=decay, out=out)
    if w.device.type != "cuda":
        raise ValueError(f"tezo_perturb runs on cuda or cpu, not {w.device}")
    B, m, n, r = check_factors(w, u, v, taus)
    k = len(scales)
    if tuple(taus.shape) != (*w.shape[:-2], k, r):
        raise ValueError(f"taus {tuple(taus.shape)} must be [..., {k}, {r}] for W "
                         f"{tuple(w.shape)}")
    out = _check_out(w, out)
    chain = _build.DeltaChain.of(scales, _decays(k, decay))
    lib = _build.load()
    with torch.cuda.device(w.device):
        err = lib.tezo_perturb_fwd(
            w.data_ptr(), out.data_ptr(), u.data_ptr(), v.data_ptr(), taus.data_ptr(),
            chain, B, m, n, r, _DTYPES[w.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "tezo_perturb_fwd")
    tezo_perturb.launches += 1
    return out


tezo_perturb.launches = 0


def lozo_chain_plain(w, u, vs, scales, decay=None, out=None):
    """The LOZO chain in plain PyTorch: one ``add_scaled`` over ``u·vᵀ`` per
    delta, the reference's jnp branch."""
    k = len(scales)
    res = w
    for s in range(k):
        res = add_scaled(res, torch.matmul(u, vs[s].transpose(-1, -2)), scales[s],
                         decay if s == k - 1 else None)
    out = w if out is None else out
    return out.copy_(res)


def lozo_chain_k(w, u, vs, scales, decay=None, out=None):
    """``scales[s]·U·vs[s]ᵀ`` for s in order, in one pass over ``w`` (in
    place, or into ``out``): ``u [..., m, r]`` the window's shared factor,
    ``vs`` k fresh ``[..., n, r]`` factors, f32.  On the card, one launch of
    the tezo_perturb kernel (counted as such) in its LOZO mode."""
    if w.device.type == "cpu":
        return lozo_chain_plain(w, u, vs, scales, decay=decay, out=out)
    if w.device.type != "cuda":
        raise ValueError(f"lozo_chain_k runs on cuda or cpu, not {w.device}")
    k = len(vs)
    if len(scales) != k or k == 0:
        raise ValueError(f"{k} V factors but {len(scales)} scales")
    for v in vs:
        B, m, n, r = check_factors(w, u, v)
    out = _check_out(w, out)
    chain = _build.DeltaChain.of(scales, _decays(k, decay))
    lib = _build.load()
    with torch.cuda.device(w.device):
        err = lib.lozo_chain_fwd(
            w.data_ptr(), out.data_ptr(), u.data_ptr(), _build.FactorList.of(vs), chain,
            B, m, n, r, _DTYPES[w.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "lozo_chain_fwd")
    tezo_perturb.launches += 1
    return out
