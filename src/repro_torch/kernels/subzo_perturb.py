"""SubZO perturbation chain: the hand-written CUDA kernel and its plain
PyTorch version.

For s = 0 .. k-1, ``W ← round_W(d_s·W + scale_s·(U·Σ_s)·Vᵀ)``, with
``d_s = 1`` except ``decay`` on the last delta, each delta rounded to W's
dtype before the next one reads it.  One call covers a whole leaf
``[..., m, n]`` with the window's orthonormal factors ``u [..., m, r]``,
``v [..., n, r]`` and the chain's cores ``sigmas [..., k, r, r]`` (all f32);
``scales`` and ``decay`` are host floats, so no step reads anything back
from the device.

Replaces the TPU kernel ``repro/kernels/zo_noise.py::subzo_perturb``
(through ``repro.kernels.ops.subzo_perturb``).  The kernel is
``csrc/subzo_perturb.cu``, two launches a call: the first forms U·Σ_s once
per leaf and delta into an f32 scratch ``[..., k, m, r]`` that this wrapper
takes from the caching allocator; the second is ``tezo_perturb``'s weight
pass over (column tiles, row tiles, batch index), W through shared memory,
with U·Σ_s as the a-side and V as the b-side, so Z never reaches device
memory.  r runs up to ``MAX_RANK``.  It writes in place unless ``out`` names
another buffer of W's shape.

On a CPU tensor :func:`subzo_perturb` runs :func:`subzo_perturb_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tezo_perturb import (
    _DTYPES,
    _check_out,
    _decays,
    add_scaled,
    check_factors,
)

MAX_RANK = 4096  # csrc/subzo_perturb.cu kMaxRank


def subzo_perturb_plain(w, u, v, sigmas, scales, decay=None, out=None):
    """The kernel's function in plain PyTorch: one ``add_scaled`` over
    ``(u @ Σ_s) @ vᵀ`` per delta."""
    k = len(scales)
    vt = v.transpose(-1, -2)
    res = w
    for s in range(k):
        z = torch.matmul(torch.matmul(u, sigmas[..., s, :, :]), vt)
        res = add_scaled(res, z, scales[s], decay if s == k - 1 else None)
    out = w if out is None else out
    return out.copy_(res)


def subzo_perturb(w, u, v, sigmas, scales, decay=None, out=None):
    """Apply the delta chain to ``w`` (in place, or into ``out``) and return
    the result.  ``sigmas`` is ``[..., k, r, r]`` f32 with
    ``len(scales) == k``."""
    _build.check_chain(len(scales))
    if w.device.type == "cpu":
        return subzo_perturb_plain(w, u, v, sigmas, scales, decay=decay, out=out)
    if w.device.type != "cuda":
        raise ValueError(f"subzo_perturb runs on cuda or cpu, not {w.device}")
    B, m, n, r = check_factors(w, u, v, sigmas)
    k = len(scales)
    if tuple(sigmas.shape) != (*w.shape[:-2], k, r, r):
        raise ValueError(f"sigmas {tuple(sigmas.shape)} must be [..., {k}, {r}, {r}] for W "
                         f"{tuple(w.shape)}")
    if r > MAX_RANK:
        raise ValueError(f"subzo_perturb takes r <= {MAX_RANK}, not {r}")
    out = _check_out(w, out)
    chain = _build.DeltaChain.of(scales, _decays(k, decay))
    lib = _build.load()
    with torch.cuda.device(w.device):
        us = torch.empty((B, k, m, r), dtype=torch.float32, device=w.device)  # U·Σ_s
        err = lib.subzo_perturb_fwd(
            w.data_ptr(), out.data_ptr(), u.data_ptr(), v.data_ptr(), sigmas.data_ptr(),
            us.data_ptr(), chain, B, m, n, r, _DTYPES[w.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "subzo_perturb_fwd")
    subzo_perturb.launches += 1
    return out


subzo_perturb.launches = 0
