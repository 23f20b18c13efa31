"""Forward flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(through ``repro.kernels.ops.flash_attention``).  The kernel is
``csrc/flash_attention.cu``.  For bf16 inputs (every full-width config) one
CUDA block of four warps owns 32 query rows of one (head, batch row): two
slices of 16 rows, each taken by two warps that share out the 64-row K/V
tiles (32 above a head dim of 64) and combine their softmax states at the
end.  ``cp.async`` copies the tiles into a two-stage ring of bf16 tiles in
shared memory, the next round's copies in flight during this round's
products; QKᵀ
and PV run on the tensor cores (``mma.sync`` m16n8k16, bf16 -> f32, P
split into a bf16 high and low part so it keeps ~16 bits), with the
online-softmax state (m, l, acc) in f32 registers in the accumulator's
layout.  f32 inputs (the smoke configs) keep the CUDA-core body: one block
per (64-row q-tile, head, batch row), f32 FMAs, as the repo's f32 numerics
(full-f32 dots, TF32 off) ask.  At the main path's shapes a call's bytes
and products take under a microsecond at the H100's peaks, so its time is
latency: the launch and each block's chain of tile loads and products.
The score tile never reaches device memory.  See the source for the
design.

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
# a bf16 block (csrc/flash_attention.cu): its slices of 16 query rows, the
# warps that share out each slice's kv tiles (at head dims <= 128), and the
# kv rows of a tile
ROW_WARPS, KV_WARPS, KV_TILE = 2, 2, 64


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
    _build.forbid_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, q_offset=q_offset
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    out = _launch(q, k, v, causal, window, q_offset, 0)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _launch(q, k, v, causal, window, q_offset, warps):
    q_offset, window = int(q_offset), int(window)
    _check(q, k, v, q_offset, window)
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    lib = _build.load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H, KV, dh,
            q_offset, window, int(bool(causal)), dh**-0.5, _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        if warps == 0:
            err, entry = lib.flash_attention_fwd(*args, stream), "flash_attention_fwd"
        else:
            err, entry = lib.flash_attention_fwd_warps(*args, warps, stream), \
                "flash_attention_fwd_warps"
    _build.check(err, entry)
    return out


# the bf16 blocks flash_attention_warps times: (row warps, kv warps, kv tile)
WARP_CHOICES = [(2, 1, 64), (4, 1, 64), (1, 2, 64), (2, 2, 64), (1, 2, 32), (2, 2, 32),
                (4, 2, 32), (1, 4, 32)]


def flash_attention_warps(q, k, v, row_warps: int, kv_warps: int, kv_tile: int, *,
                          causal=True, window=0, q_offset=0):
    """The bf16 kernel with another block (one of ``WARP_CHOICES``), at a
    head dim up to 64: for timing the choice of (ROW_WARPS, KV_WARPS,
    KV_TILE).  The forward calls :func:`flash_attention`; this launch is not
    counted."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_warps times the bf16 kernel on a CUDA tensor")
    if (row_warps, kv_warps, kv_tile) not in WARP_CHOICES:
        raise ValueError(f"({row_warps}, {kv_warps}, {kv_tile}) is not one of {WARP_CHOICES}")
    return _launch(q, k, v, causal, window, q_offset,
                   1000 * row_warps + 100 * kv_warps + kv_tile)
