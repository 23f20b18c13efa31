"""Model config dataclass: the port's copy of ``repro.configs.base.ModelConfig``.

The port keeps its own copy instead of importing the reference's, with the
fields the ported code reads, under the reference's names and defaults.
The block is opt-125m's: no qkv bias, no qk-norm, full causal attention,
the 2-matrix GELU FFN, no experts.  The reference's fields for the other
choices (``qkv_bias``, ``qk_norm``, ``window``, ``activation``,
``n_experts``) and for features not ported yet (the SSM / hybrid families,
sharding hints, chunked cross-entropy) come with a registered config that
sets them.  There is no ``kernel_mode``: the tensor's device decides
between a kernel and its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # ---- numerics ---------------------------------------------------------
    dtype: str = "bfloat16"
    attn_chunked_min_seq: int = 8192  # CPU: plain flash version at >= this
    decode_cache_dtype: str = "bfloat16"

    def reduced(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)
