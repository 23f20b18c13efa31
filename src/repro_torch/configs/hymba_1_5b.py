"""hymba-1.5b [hybrid] (a copy of ``repro.configs.hymba_1_5b``): parallel
attention and Mamba heads (arXiv:2411.13676).  32L d_model=1600 25H (kv=5)
head_dim=64 d_ff=5504 vocab=32001 ssm_state=16; sliding-window attention
(W=1024) keeps the decode state O(1) in context."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    window=1024,
)

SMOKE = CONFIG.reduced(
    name="hymba-1.5b-smoke",
    n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=128, ssm_state=4, window=16, dtype="float32",
)
