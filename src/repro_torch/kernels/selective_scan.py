"""Mamba-1 selective scan: the hand-written CUDA kernel and its plain
PyTorch version.

For each (batch b, channel d, state n), over t in order,
``h ← exp(dt[b,t,d]·A[d,n])·h + (dt[b,t,d]·x[b,t,d])·B[b,t,n]`` and
``y[b,t,d] = Σ_n h·C[b,t,n]``, from ``h = h0[b,d,:]``.  Returns
``(y [B,S,D] f32, h_last [B,D,N] f32)``; the caller adds the D∘x skip.

Replaces the TPU kernel ``repro/kernels/selective_scan.py::selective_scan``
(through ``repro.kernels.ops.selective_scan``).  The kernel is
``csrc/selective_scan.cu``: one thread per (b, d) row keeps the row's
N-vector of f32 state (N ≤ ``MAX_STATE``) in registers for the whole
sequence, B_t and C_t staged in shared memory in chunks of time steps; x,
dt and y are read and written once.  Unlike ``repro.kernels.ops`` the
wrapper pads nothing: the kernel masks ragged channels itself and loops
over any S, so ``h_last`` is exact and carries across calls.

On a CPU tensor :func:`selective_scan` runs :func:`selective_scan_plain`;
on a CUDA tensor it launches the kernel, at every S (S = 1 included), or
raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STATE = 64  # csrc/selective_scan.cu: N <= 64 by template


def selective_scan_plain(x, dt, a, b, c, h0):
    """The kernel's function in plain PyTorch: a sequential loop over S in
    the kernel's arithmetic (every input in f32; ``exp(dt·A)``; the two
    products of the update rounded apart, then added; y summed over n in
    ascending order), the counterpart of ``repro.kernels.ref.
    selective_scan_ref``."""
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    h = h0.float().clone()  # [B, D, N]
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t, :, None]  # [B, D, 1]
        da = torch.exp(dt_t * a)
        h = da * h + (dt_t * x[:, t, :, None]) * b[:, t, None, :]
        hc = h * c[:, t, None, :]
        y = hc[..., 0]
        for n in range(1, hc.shape[-1]):
            y = y + hc[..., n]
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _check(x, dt, a, b, c, h0):
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"expected x, dt [B,S,D]; got {tuple(x.shape)}, {tuple(dt.shape)}")
    B, S, D = x.shape
    N = a.shape[-1]
    if a.shape != (D, N) or b.shape != (B, S, N) or c.shape != (B, S, N) \
            or h0.shape != (B, D, N):
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, h0 "
                         f"{tuple(h0.shape)} do not match x {tuple(x.shape)} with N={N}")
    if N > MAX_STATE:
        raise ValueError(f"selective_scan takes a state of N <= {MAX_STATE}, not {N}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c), ("h0", h0)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return B, S, D, N


def selective_scan(x, dt, a, b, c, h0):
    """x, dt [B,S,D]; a [D,N] (negative); b, c [B,S,N]; h0 [B,D,N] ->
    (y [B,S,D] f32, h_last [B,D,N] f32).  Inputs are read as f32."""
    _build.forbid_autograd("selective_scan", x, dt, a, b, c, h0)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, a, b, c, h0)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu, not {x.device}")
    B, S, D, N = _check(x, dt, a, b, c, h0)
    x, dt, a, b, c, h0 = (t.float().contiguous() for t in (x, dt, a, b, c, h0))
    y = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, D, N,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "selective_scan_fwd")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
