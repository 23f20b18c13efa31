"""Shared neural layers (counterpart of ``repro.models.layers``): norms,
RoPE, attention (full / decode / paged decode / paged verify), the weight
matmul (dense or quantized), the gated MLP (swiglu, geglu, or the 2-matrix
gelu FFN) and the cross-entropy loss.
Plain functions over tensors; softmax and norm math in f32, activations in
the config dtype, as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantLeaf

NEG_INF = -1e30


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings (llama-style half rotation)
# --------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions [...] int -> (sin, cos) each [..., head_dim/2] f32."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, N, dh]; sin/cos [B?, S, dh/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    s = sin[..., None, :]
    c = cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _promote(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Cast both operands to their promoted dtype (jnp promotes implicitly;
    torch's products require one dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def full_attention(q, k, v, *, window: int = 0, q_offset: int = 0):
    """Materialized-scores causal attention (S² memory), sliding-window when
    ``window`` > 0 (kpos > qpos - window).  q [B,S,H,dh], k/v [B,T,KV,dh].
    Products run in the input dtype, as the reference's."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh**-0.5
    qg, k = _promote(q.reshape(B, S, KV, G, dh), k)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    allow = kpos[None, :] <= qpos[:, None]
    if window > 0:
        allow = allow & (qpos[:, None] - kpos[None, :] < window)
    s = torch.where(allow, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(B, S, H, dh)


def decode_attention(q, k_cache, v_cache, valid_mask):
    """q [B,1,H,dh] against a dense cache [B,T,KV,dh]; valid_mask [T] or
    [B,T] bool.  No kernel here, in the reference either."""
    B, _, H, dh = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = dh**-0.5
    qg, k = _promote(q.reshape(B, KV, G, dh), k_cache)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k).float() * scale
    mask = valid_mask if valid_mask.dim() == 2 else valid_mask[None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache)
    return out.reshape(B, 1, H, dh)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """Port of the reference's XLA twin of the paged decode kernel: gather
    each slot's pages into a contiguous per-slot cache, then the dense
    ``decode_attention`` math.  A length-0 slot gets a uniform softmax over
    its (null-page) rows here — the kernel and its plain version give exact
    zeros instead.  Nothing on the serving path calls this; the tests hold
    it against the reference's twin."""
    S, H, dh = q.shape
    KV = k_pages.shape[2]
    bt = block_tables.long()
    k = k_pages[bt].reshape(S, -1, KV, dh)
    v = v_pages[bt].reshape(S, -1, KV, dh)
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    return decode_attention(q[:, None], k, v, valid)[:, 0]


def paged_verify_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """Port of the reference's XLA twin of the speculative-verify kernel,
    built by folding the draft window into the slot axis: each (slot, t)
    pair becomes a pseudo-slot sharing the slot's block-table row with
    length ``lengths[s] + t`` (the causal intra-window mask), then the
    :func:`paged_decode_attention_ref` math runs over the S·T pseudo-slots.
    At T = 1 this is the decode twin's call.  Dead slots (length 0) keep
    length 0 at every window position.  q [S,T,H,dh] -> [S,T,H,dh].  As with
    the decode twin, nothing on the serving path calls this."""
    S, T, H, dh = q.shape
    bt_rep = torch.repeat_interleave(block_tables, T, dim=0)  # [S*T, P]
    lens_t = torch.where((lengths > 0)[:, None],
                         lengths[:, None] + torch.arange(T, device=q.device)[None, :], 0)
    out = paged_decode_attention_ref(q.reshape(S * T, H, dh), k_pages, v_pages, bt_rep,
                                     lens_t.reshape(-1).to(lengths.dtype))
    return out.reshape(S, T, H, dh)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """Paged-KV decode-attention entry point (``core.dispatch``)."""
    from repro_torch.core import dispatch

    return dispatch.decode_attention_fwd(q, k_pages, v_pages, block_tables, lengths)


def paged_verify_attention(q, k_pages, v_pages, block_tables, lengths):
    """Multi-token speculative-verify attention over the paged KV cache
    (``core.dispatch``): q [S,T,H,dh], window position t attends
    ``kpos < lengths[s] + t``."""
    from repro_torch.core import dispatch

    return dispatch.verify_attention_fwd(q, k_pages, v_pages, block_tables, lengths)


def attention(q, k, v, *, window=0, q_offset=0, chunked_min_seq=8192):
    """Forward-attention entry point (``core.dispatch``)."""
    from repro_torch.core import dispatch

    return dispatch.attention_fwd(q, k, v, window=window, q_offset=q_offset,
                                  chunked_min_seq=chunked_min_seq)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def weight_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a dense matrix or a ``core.quant.QuantLeaf``.
    The quantized branch routes through ``dispatch.quant_matmul_fwd`` (the
    fused in-tile LUT-dequant kernel on the card, its plain version on the
    CPU); the dense branch is left to ``torch.matmul`` as the reference
    leaves it to XLA's dot.  Every weight-matmul site of the training
    forward, prefill, decode and verify goes through here."""
    if isinstance(w, QuantLeaf):
        from repro_torch.core import dispatch

        return dispatch.quant_matmul_fwd(x, w)
    if x.dtype != w.dtype:
        x, w = _promote(x, w)
    return torch.matmul(x, w)


def top_k(x: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order and their indices, the lower index first among equal
    values (``torch.topk`` promises no order among ties, which in a bf16
    router's probabilities are common).  A stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gated_mlp(x, w_gate, w_up, w_down, activation="swiglu"):
    """The reference's ``gated_mlp``: ``act(x @ w_gate) * (x @ w_up) @
    w_down`` with the activation in f32 (SiLU for ``"swiglu"``, the tanh
    approximation of GELU for ``"geglu"``), or with ``activation="gelu"``
    the classic 2-matrix FFN (OPT style, ``w_gate`` unused)."""
    u = weight_matmul(x, w_up)
    if activation == "gelu":
        a = F.gelu(u.float(), approximate="tanh").to(x.dtype)
        return weight_matmul(a, w_down)
    g = weight_matmul(x, w_gate)
    if activation == "swiglu":
        a = F.silu(g.float()).to(x.dtype)
    elif activation == "geglu":
        a = F.gelu(g.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(activation)
    return weight_matmul(a * u, w_down)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _token_nll(logits, targets):
    """Each token's NLL in f32: logsumexp − gold logit."""
    logits = logits.float()
    gold = torch.take_along_dim(logits, targets.long()[..., None], dim=-1)[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy_sums(logits, targets, mask=None):
    """(sum of the token NLLs, token count), f32 scalars, masked by a {0,1}
    ``mask`` when given: the parts of :func:`cross_entropy` that a sharded
    loss adds over the data lanes before it divides."""
    nll = _token_nll(logits, targets)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask), torch.sum(mask)
    return torch.sum(nll), nll.new_full((), float(nll.numel()))


def cross_entropy(logits, targets, mask=None):
    """Mean token NLL in f32: logsumexp − gold logit, masked mean when a
    {0,1} ``mask`` [B, S] is given.  logits [B, S, V], targets [B, S]."""
    nll = _token_nll(logits, targets)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
