"""qwen3-32b [dense] (a copy of ``repro.configs.qwen3_32b``): GQA with
qk-norm (hf:Qwen/Qwen3-32B family). 64L d_model=5120 64H (kv=8, head_dim=128
— note 64·128=8192 != d_model, faithful to the HF config) d_ff=25600
vocab=151936."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.reduced(
    name="qwen3-32b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=256, dtype="float32",
)
