"""Model config dataclass: the port's copy of ``repro.configs.base.ModelConfig``.

The port keeps its own copy instead of importing the reference's, with the
fields the ported code reads, under the reference's names and defaults:
the dense block (opt-125m: no qkv bias, no qk-norm, the 2-matrix GELU FFN
through ``activation="gelu"``) and the hybrid block (hymba-1.5b: sliding
``window`` attention, the Mamba path's ``ssm_state``, ``ssm_expand`` and
``conv_width``, the SwiGLU FFN).  The reference's fields for the other
families (``qkv_bias``, ``qk_norm``, ``n_experts``, xLSTM's, the prefix
embeds), sharding hints and chunked cross-entropy come with a registered
config that sets them.  There is no ``kernel_mode``: the tensor's device
decides between a kernel and its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" or "hybrid" are ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10_000.0
    window: int = 0  # sliding-window size; 0 = full causal
    # ---- block options ----------------------------------------------------
    activation: str = "swiglu"  # swiglu | gelu
    norm_eps: float = 1e-6
    # ---- SSM / hybrid -----------------------------------------------------
    ssm_state: int = 0  # mamba state N (hymba)
    ssm_expand: int = 2  # mamba inner expansion
    conv_width: int = 4  # mamba depthwise conv width
    # ---- numerics ---------------------------------------------------------
    dtype: str = "bfloat16"
    attn_chunked_min_seq: int = 8192  # CPU: plain flash version at >= this
    decode_cache_dtype: str = "bfloat16"

    def reduced(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)
