"""Forward-compute dispatch: the one place that picks an attention lowering
(counterpart of the forward section of ``repro.core.dispatch``).

There is no knob: the tensor's device decides.  On a CUDA tensor each
function launches its hand-written kernel (or the wrapper raises — there
is no ``try`` and no fallback).  On a CPU tensor each runs the plain
version; prefill additionally keeps the reference's XLA-path rule of
materialized full attention below ``chunked_min_seq`` on the CPU.  On the
card, prefill always goes through the flash kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import flash_attention


def attention_fwd(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, T, KV, dh]
    v: torch.Tensor,  # [B, T, KV, dh]
    *,
    q_offset: int = 0,
    chunked_min_seq: int = 8192,
) -> torch.Tensor:
    """Causal (GQA) prefill attention for one block."""
    if q.device.type == "cpu" and q.shape[1] < chunked_min_seq:
        from repro_torch.models import layers  # lazy: layers imports this module

        return layers.full_attention(q, k, v, q_offset=q_offset)
    return flash_attention(q, k, v, causal=True, q_offset=q_offset)


def decode_attention_fwd(
    q: torch.Tensor,  # [S, H, dh] one query token per decode slot
    k_pages: torch.Tensor,  # [n_pages, page_size, KV, dh] shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_slot] int32 physical page ids
    lengths: torch.Tensor,  # [S] int32 valid kv length per slot
) -> torch.Tensor:
    """Paged (block-table) KV-cache decode attention for one step."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, lengths)
