"""kimi-k2-1t-a32b [moe] (a copy of ``repro.configs.kimi_k2``): a
trillion-parameter fine-grained MoE.  61L d_model=7168 64H (kv=8,
head_dim=112) d_ff=2048, 384 experts top-8, vocab=163840.  The real K2
uses MLA attention; the reference pins GQA with 8 KV heads, and so does
the port."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    n_experts_per_token=8,
    rope_theta=50_000.0,
)

SMOKE = CONFIG.reduced(
    name="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, n_experts=8, n_experts_per_token=2,
    dtype="float32",
)
