"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP patch-embedding stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064,
        vision_prefix=576,
        pattern=("attn",),
        source="hf:microsoft/Phi-3-vision-128k-instruct",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="phi3v-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        vision_prefix=16,
        pattern=("attn",),
    )
