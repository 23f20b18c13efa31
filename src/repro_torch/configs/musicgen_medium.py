"""musicgen-medium [audio] (a copy of ``repro.configs.musicgen_medium``):
decoder-only transformer over EnCodec tokens (arXiv:2306.05284). 48L
d_model=1536 24H (MHA, kv=24) d_ff=6144 vocab=2048. The EnCodec/conditioning
frontend is a stub: the batch carries 256 precomputed frame embeddings as a
prefix (assignment: "input_specs() provides precomputed frame embeddings").
Classic 2-matrix GELU FFN (d_ff = 4·d)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    activation="gelu",
    n_prefix_embeds=256,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.reduced(
    name="musicgen-medium-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=128, n_prefix_embeds=8, dtype="float32",
)
