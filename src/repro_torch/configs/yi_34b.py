"""yi-34b [dense] (a copy of ``repro.configs.yi_34b``): llama-arch GQA
(arXiv:2403.04652). 60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
)

SMOKE = CONFIG.reduced(
    name="yi-34b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=256, dtype="float32",
)
