"""Forward flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(through ``repro.kernels.ops.flash_attention``).  The kernel is
``csrc/flash_attention.cu``: one CUDA block per (64-row q-tile, head, batch
row) loops over 32-row K/V tiles staged in shared memory, with the
online-softmax state (m, l, acc) in f32 registers (32-row q-tiles and
16-row K/V tiles at a head dim above 128).  On the H100 its work is
the two attention products, run here as f32 FMAs on the CUDA cores (not the
tensor cores), so the operations bound it; the score tile never reaches
device memory.  See the source for the design.

Unlike ``repro.kernels.ops`` the wrapper pads nothing: the kernel masks
kpos >= T and rows >= S itself, and takes any dh <= 256 (the repo's
largest config, paligemma-3b, has 256).

On a CPU tensor :func:`flash_attention` runs :func:`flash_attention_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0):
    """The kernel's function in plain PyTorch: materialized f32 scores, one
    softmax.  q [B,S,H,dh], k/v [B,T,KV,dh] -> [B,S,H,dh] in q's dtype."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * dh**-0.5
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    allow = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        allow = allow & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        allow = allow & (qpos[:, None] - kpos[None, :] < window)
    s = torch.where(allow, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def _check(q, k, v, q_offset, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,S,H,dh], k/v [B,T,KV,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM} is not supported")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share f32 or bf16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_offset < 0 or window < 0:
        raise ValueError(f"q_offset={q_offset} and window={window} must be >= 0")


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Causal (GQA, sliding-window, q_offset) forward attention.
    q [B,S,H,dh], k/v [B,T,KV,dh] -> [B,S,H,dh] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, q_offset=q_offset
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    q_offset, window = int(q_offset), int(window)
    _check(q, k, v, q_offset, window)
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, dh, q_offset, window, int(bool(causal)),
            dh**-0.5, _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
