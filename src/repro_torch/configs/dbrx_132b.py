"""dbrx-132b [moe] (a copy of ``repro.configs.dbrx_132b``): 16 experts
top-4, fine-grained (hf:databricks/dbrx-base).  40L d_model=6144 48H (kv=8)
d_ff=10752 vocab=100352."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    n_experts_per_token=4,
    rope_theta=500_000.0,
)

SMOKE = CONFIG.reduced(
    name="dbrx-132b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=48, vocab_size=256, n_experts=4, n_experts_per_token=2,
    dtype="float32",
)
