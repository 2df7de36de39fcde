"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks, no FFN
[arXiv:2405.04517; unverified]."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        pattern=("mlstm", "slstm"),
        source="arXiv:2405.04517",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=256,
        pattern=("mlstm", "slstm"),
    )
