"""xlstm-350m [ssm] (a copy of ``repro.configs.xlstm_350m``): sLSTM + mLSTM
blocks (arXiv:2405.04517).  24L d_model=1024 4H d_ff=0 (the projection is
inside the block) vocab=50304.  sLSTM at layers 7/15/23 (the paper's
sparse-sLSTM placement); the rest mLSTM.  The decode state is O(1) in
context."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    slstm_layers=(7, 15, 23),
)

SMOKE = CONFIG.reduced(
    name="xlstm-350m-smoke",
    n_layers=3, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
    vocab_size=128, slstm_layers=(1,), dtype="float32",
)
