"""qwen2.5-14b [dense] (a copy of ``repro.configs.qwen2_5_14b``): GQA with
QKV bias (hf:Qwen/Qwen2.5-14B family). 48L d_model=5120 40H (kv=8)
d_ff=13824 vocab=152064."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.reduced(
    name="qwen2.5-14b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=256, dtype="float32",
)
