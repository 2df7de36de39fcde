"""Model layout around the decode kernel: q (B, 1, H, hd), caches
(B, S, Kv, hd) -> (B, 1, H, hd).  The counterpart of the reference's
``decode_attn/ops.py``; the cache transposes are views, read in place by the
kernel on the card."""

from __future__ import annotations

import torch

from .decode_attention import Length, decode_attention


def decode_attention_op(
    q: torch.Tensor,               # (B, 1, H, hd)
    k_cache: torch.Tensor,         # (B, S, Kv, hd)
    v_cache: torch.Tensor,
    length: Length,
) -> torch.Tensor:
    """(B, 1, H, hd) attention of the new token over the first ``length``
    cache rows: the CUDA kernels for card tensors, the plain version for CPU
    tensors."""
    kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    return decode_attention(q[:, 0], kt, vt, length)[:, None]
