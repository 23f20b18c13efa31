"""paligemma-3b [vlm] (a copy of ``repro.configs.paligemma_3b``): SigLIP +
gemma backbone (arXiv:2407.07726). 18L d_model=2048 8H (MQA, kv=1,
head_dim=256) d_ff=16384 vocab=257216. The SigLIP frontend is a stub: 256
precomputed patch embeddings prefix the token stream (224px / patch 14 =>
16x16 patches)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    n_prefix_embeds=256,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.reduced(
    name="paligemma-3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=256, vocab_size=512, n_prefix_embeds=8, dtype="float32",
)
