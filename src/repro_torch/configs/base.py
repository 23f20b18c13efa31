"""Model config dataclass: the port's copy of ``repro.configs.base.ModelConfig``.

The port keeps its own copy instead of importing the reference's, with the
fields the ported code reads, under the reference's names and defaults:
the dense block and its options (``qkv_bias``, qwen2.5; ``qk_norm``,
qwen3; the FFN's ``activation``: SwiGLU, GeGLU or the 2-matrix GELU FFN),
the modality stubs' ``n_prefix_embeds`` (paligemma, musicgen) and the
hybrid block (hymba-1.5b: sliding ``window`` attention, the Mamba path's
``ssm_state``, ``ssm_expand`` and ``conv_width``) and the MoE block
(dbrx-132b, kimi-k2: ``n_experts``, ``n_experts_per_token``,
``moe_capacity_factor``, ``moe_impl``) and the xLSTM block (xlstm-350m:
``slstm_layers``, ``mlstm_chunk``).  The reference's sharding hints and
chunked cross-entropy come with a registered config that sets them.  The
assigned input shapes (``ShapeConfig``, ``SHAPES``) and
``long_context_capable`` are the reference's too.  There is no
``kernel_mode``: the tensor's device decides between a kernel and its
plain version, and between the mLSTM's sequential and chunkwise forms
(``models.xlstm``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # ---- attention options -----------------------------------------------
    qkv_bias: bool = False  # qwen2.5
    qk_norm: bool = False  # qwen3
    rope_theta: float = 10_000.0
    window: int = 0  # sliding-window size; 0 = full causal
    # ---- block options ----------------------------------------------------
    activation: str = "swiglu"  # swiglu | geglu | gelu (the 2-matrix FFN)
    norm_eps: float = 1e-6
    # ---- MoE ------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # gspmd (scatter dispatch, gather combine) | ep: the expert-parallel
    # path (models.transformer._moe_ep, ROADMAP.md item 13b) runs on a mesh
    # with a model axis; without one it takes the gspmd path, as the
    # reference does
    moe_impl: str = "gspmd"
    # ---- SSM / hybrid -----------------------------------------------------
    ssm_state: int = 0  # mamba state N (hymba)
    ssm_expand: int = 2  # mamba inner expansion
    slstm_layers: tuple = ()  # xlstm: which layer indices are sLSTM
    conv_width: int = 4  # mamba depthwise conv width
    # 0: the device decides (sequential on the CPU, chunks of 256 on the
    # card); > 0: chunkwise-parallel mLSTM with this chunk size
    mlstm_chunk: int = 0
    # ---- frontends (stubs, as in the reference) ---------------------------
    n_prefix_embeds: int = 0  # precomputed modality embeddings (vlm/audio)
    # ---- numerics ---------------------------------------------------------
    dtype: str = "bfloat16"
    attn_chunked_min_seq: int = 8192  # CPU: plain flash version at >= this
    decode_cache_dtype: str = "bfloat16"

    def reduced(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


# The four assigned LM shapes (identical set for all 10 archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def long_context_capable(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM / hybrid-with-SWA);
    pure full-attention archs skip it."""
    return cfg.family in ("ssm", "hybrid")
