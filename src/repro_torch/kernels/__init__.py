# Hand-written CUDA kernels of the LM substrate, each beside its plain torch
# version (the counterpart of the reference's ``ref.py``) and a model-layout
# op (``ops.py``):
#   flash/       — causal / sliding-window / bidirectional GQA flash attention
#   decode_attn/ — split-K flash decoding (one token against a KV cache)
#   moe_gemm/    — the grouped expert GEMM of the MoE FFN
#   rglru/       — the RG-LRU diagonal linear recurrence
# The chunkwise mLSTM is still to be ported (ROADMAP.md §2).
from . import decode_attn, flash, moe_gemm, rglru

__all__ = ["decode_attn", "flash", "moe_gemm", "rglru"]
