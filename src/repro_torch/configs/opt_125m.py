"""OPT-125m-class config (a copy of ``repro.configs.opt_125m``): pre-LN
llama-style stack with RoPE instead of OPT's learned positions; 2-matrix
GELU FFN as in OPT."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-125m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50272,
    activation="gelu",
)

SMOKE = CONFIG.reduced(
    name="opt-125m-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    dtype="float32",
)
