"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attention per
2 recurrent blocks [arXiv:2402.19427; unverified]."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000,
        window=2048, pattern=("rglru", "rglru", "local"),
        source="arXiv:2402.19427",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="recurrentgemma-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=256,
        window=16, pattern=("rglru", "rglru", "local"),
    )
