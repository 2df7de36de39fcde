"""whisper-large-v3 [audio] — encoder-decoder; conv frontend is a STUB
(input_specs provides precomputed mel-frame embeddings) [arXiv:2212.04356]."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866,
        enc_dec=True, n_enc_layers=32, enc_seq=1500,
        audio_frontend=True,
        pattern=("attn",),
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        enc_dec=True, n_enc_layers=2, enc_seq=32,
        audio_frontend=True,
        pattern=("attn",),
    )
