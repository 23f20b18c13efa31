"""Paged (block-table) KV-cache decode attention: the hand-written CUDA
kernel and its plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::paged_decode_attention`` (through
``repro.kernels.ops.paged_decode_attention``).  The kernel is
``csrc/paged_decode_attention.cu``: one CUDA block per (slot, kv head)
reads its own block-table row and length (the TPU kernel's scalar
prefetch), loops over the slot's live positions in chunks gathered through
the table, masks the tail page, and serves the G = H / KV query rows of the
head together.  A length-0 slot writes exact zeros.  On the H100 it is
bound by the bytes of the live KV pages.  See the source for the design.

Unlike ``repro.kernels.ops`` the wrapper pads neither G nor dh.

Dead slots: the plain version here follows the kernel (exact zeros for a
length-0 slot).  The reference's XLA twin
(``repro.models.layers.paged_decode_attention_ref``, ported as
``repro_torch.models.layers.paged_decode_attention_ref``) instead spreads a
uniform softmax over the null page's rows for such a slot.

On a CPU tensor :func:`paged_decode_attention` runs
:func:`paged_decode_attention_plain`; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
MAX_GROUP_ELEMS = 1024  # G * head dim padded to 32/64/128 (kernel registers)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, page dtype) pairs the kernel takes: an f32 model keeps a bf16
# cache, as the reference's ``decode_cache_dtype`` default does
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lengths):
    """The kernel's function in plain PyTorch: gather each slot's pages,
    f32 scores over kpos < length, one softmax, zeros for length-0 slots.
    q [S,H,dh] -> [S,H,dh] in q's dtype."""
    S, H, dh = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    bt = block_tables.long()
    k = k_pages[bt].reshape(S, -1, KV, dh).float()  # [S, P*page_size, KV, dh]
    v = v_pages[bt].reshape(S, -1, KV, dh).float()
    qg = q.float().reshape(S, KV, G, dh)
    s = torch.einsum("skgd,stkd->skgt", qg, k) * dh**-0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    valid = kpos[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("skgt,stkd->skgd", p, v)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(S, H, dh).to(q.dtype)


def _check(q, k_pages, v_pages, block_tables, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q [S,H,dh], pages [n,ps,KV,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}")
    S, H, dh = q.shape
    KV = k_pages.shape[2]
    if k_pages.shape[3] != dh or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and pages {tuple(k_pages.shape)} disagree")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM} is not supported")
    dh_pad = 32 if dh <= 32 else 64 if dh <= 64 else 128
    if (H // KV) * dh_pad > MAX_GROUP_ELEMS:
        raise ValueError(f"G={H // KV} query rows of dh {dh} exceed the kernel's "
                         f"{MAX_GROUP_ELEMS} register elements")
    if block_tables.shape[0] != S or lengths.shape != (S,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {S} slots")
    if (q.dtype, k_pages.dtype) not in _PAIRS or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"unsupported q / pages dtypes {q.dtype} / {k_pages.dtype}, "
                        f"{v_pages.dtype}; supported: {sorted(map(str, _PAIRS))}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """One query per slot against its pages.  q [S,H,dh], k/v_pages
    [n_pages,page_size,KV,dh], block_tables [S,P] int32, lengths [S] int32
    (kpos < min(length, P * page_size) attends) -> [S,H,dh] in q's dtype.
    Table entries below ceil(length / page_size) must be valid page ids; the
    rest are not read."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_pages, v_pages, block_tables, lengths)
    S, H, dh = q.shape
    page_size, KV = k_pages.shape[1], k_pages.shape[2]
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            S, H, KV, dh, page_size, block_tables.shape[1], dh**-0.5,
            _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "paged_decode_attention_fwd")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
