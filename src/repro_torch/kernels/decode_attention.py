"""Paged (block-table) KV-cache attention for decode and speculative
verify: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernels
``repro/kernels/decode_attention.py::paged_decode_attention`` and
``::paged_verify_attention`` (through ``repro.kernels.ops``).  One kernel
serves both: ``csrc/paged_verify_attention.cu`` attends a window of T query
tokens per slot, window position t reading ``kpos < lengths[s] + t`` (the
slot's history plus the causal intra-window prefix), and the decode entry
point (``csrc/paged_decode_attention.cu``) launches it with T = 1, so a
T = 1 verify is bitwise a decode step, as in the reference.

The kv axis is split across blocks: one CUDA block per (slot, kv head,
split of :data:`SPLIT` positions, block of query rows) reads its slot's
length and its split's block-table entries (the TPU kernel's scalar
prefetch), gathers the split's K/V rows by ``cp.async`` into a two-stage
ring in shared memory, masks the tail page, and writes a partial softmax
state (m, l, acc) per row to a workspace this wrapper allocates
(:func:`workspace_floats`); a second kernel combines each row's splits in
ascending order.  The split, like every tile size, is a constant of the
head dim and the dtypes, never of T, the slot count or the lengths, so a
window row is bitwise the decode kernel at its length.  Every limit is
clamped to the slot's ``pages_per_slot * page_size`` positions; a length-0
slot writes exact zeros.  The products run on the CUDA cores (a row is a
matrix-vector product at opt-125m's G = 1), in f32 for every dtype pair.
On the H100 a call at decode's sizes moves ~2.5 MB, under a microsecond at
the card's bandwidth, so its time is latency: two launches and three
dependent reads per block.  See the source for the design.

Unlike ``repro.kernels.ops`` the wrappers pad neither G nor dh.  The kernel
holds 1024 / dh_pad query rows per block in registers (dh padded to 32,
64, 128 or 256) and puts further rows of a wide window (T * G above that)
in further blocks, so it takes any T and G and a head dim up to 256.

Dead slots: the plain version here follows the kernel (exact zeros for a
length-0 slot).  The reference's XLA twins
(``repro.models.layers.paged_decode_attention_ref`` and
``paged_verify_attention_ref``, ported in ``repro_torch.models.layers``)
instead spread a uniform softmax over the null page's rows for such a slot.

On a CPU tensor :func:`paged_decode_attention` and
:func:`paged_verify_attention` run their plain versions; on a CUDA tensor
they launch the kernels or raise.  Each call on the card is two launches,
the split kernel (counted in ``launches``) and the combine kernel (counted
in ``combine_launches``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, page dtype) pairs the kernel takes: an f32 model keeps a bf16
# cache, as the reference's ``decode_cache_dtype`` default does
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}
SPLIT = 64  # kv positions per split block: csrc/paged_attention.cuh kPagedSplit


def split_count(pages_per_slot: int, page_size: int) -> int:
    """Splits of a slot's ``pages_per_slot * page_size`` positions: the
    kernel's grid covers a full slot, and a block past its rows' reach
    exits at once."""
    return -(-pages_per_slot * page_size // SPLIT)


def workspace_floats(S: int, T: int, H: int, dh: int, pages_per_slot: int,
                     page_size: int) -> int:
    """f32 workspace of one call: per (slot, window position, head) and
    split, the partial (m, l) and acc's dh values."""
    return S * T * H * split_count(pages_per_slot, page_size) * (dh + 2)


def paged_verify_attention_plain(q, k_pages, v_pages, block_tables, lengths):
    """The kernel's function in plain PyTorch: gather each slot's pages, f32
    scores, window position t over kpos < lengths + t (the gathered
    ``pages_per_slot * page_size`` positions bound it), one softmax, zeros
    for length-0 slots.  q [S,T,H,dh] -> [S,T,H,dh] in q's dtype."""
    S, T, H, dh = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    bt = block_tables.long()
    k = k_pages[bt].reshape(S, -1, KV, dh).float()  # [S, P*page_size, KV, dh]
    v = v_pages[bt].reshape(S, -1, KV, dh).float()
    qg = q.float().reshape(S, T, KV, G, dh)
    s = torch.einsum("stkgd,sjkd->stkgj", qg, k) * dh**-0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    lim = lengths[:, None] + torch.arange(T, device=q.device)[None, :]  # [S, T]
    valid = kpos[None, None, :] < lim[:, :, None]
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("stkgj,sjkd->stkgd", p, v)
    out = torch.where((lengths > 0)[:, None, None, None, None], out, 0.0)
    return out.reshape(S, T, H, dh).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lengths):
    """The decode kernel's function in plain PyTorch: the verify plain
    version over a window of one token.  q [S,H,dh] -> [S,H,dh]."""
    return paged_verify_attention_plain(q[:, None], k_pages, v_pages, block_tables,
                                        lengths)[:, 0]


def _check(q, k_pages, v_pages, block_tables, lengths):
    """Validate a window call, q [S,T,H,dh]; returns (S, T, H, dh)."""
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q [S,T,H,dh], pages [n,ps,KV,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}")
    S, T, H, dh = q.shape
    KV = k_pages.shape[2]
    if k_pages.shape[3] != dh or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and pages {tuple(k_pages.shape)} disagree")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM} is not supported")
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
    return S, T, H, dh


def _launch(entry: str, q, k_pages, v_pages, block_tables, lengths, window: bool):
    """One call of the shared kernels (the split kernel, then the combine
    kernel) through the C entry ``entry``; q is [S,T,H,dh] (``window``) or
    [S,H,dh]."""
    qw = q if window else q[:, None]
    S, T, H, dh = _check(qw, k_pages, v_pages, block_tables, lengths)
    page_size, KV = k_pages.shape[1], k_pages.shape[2]
    pps = block_tables.shape[1]
    lib = _build.load()
    out = torch.empty_like(q)
    # freed when this returns: the caching allocator hands the block out again
    # only to work queued after both kernels on this stream
    work = torch.empty(workspace_floats(S, T, H, dh, pps, page_size), dtype=torch.float32,
                       device=q.device)
    shape = (S, T, H, KV) if window else (S, H, KV)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            work.data_ptr(), work.numel(), *shape, dh, page_size, pps, dh**-0.5,
            _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, entry)
    return out


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
    if q.dim() != 3:
        raise ValueError(f"expected q [S,H,dh]; got {tuple(q.shape)}")
    out = _launch("paged_decode_attention_fwd", q, k_pages, v_pages, block_tables, lengths,
                  window=False)
    paged_decode_attention.launches += 1
    paged_decode_attention.combine_launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.combine_launches = 0


def paged_verify_attention(q, k_pages, v_pages, block_tables, lengths):
    """A T-token window per slot against its pages.  q [S,T,H,dh], pages,
    tables as :func:`paged_decode_attention`; ``lengths[s]`` is the kv count
    window position 0 attends, position t attends kpos < min(lengths[s] + t,
    P * page_size) -> [S,T,H,dh] in q's dtype.  Table entries below
    ceil((lengths[s] + T - 1) / page_size), capped at P, must be valid page
    ids."""
    if q.device.type == "cpu":
        return paged_verify_attention_plain(q, k_pages, v_pages, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention runs on cuda or cpu, not {q.device}")
    out = _launch("paged_verify_attention_fwd", q, k_pages, v_pages, block_tables, lengths,
                  window=True)
    paged_verify_attention.launches += 1
    paged_verify_attention.combine_launches += 1
    return out


paged_verify_attention.launches = 0
paged_verify_attention.combine_launches = 0
