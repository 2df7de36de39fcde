"""Model layout (B, S, H, hd) around the flash kernel's layout (B, H, S, hd).

The counterpart of the reference's ``flash/ops.py``.  The transposes are
views: the kernel reads and writes strided tensors, so no copy is made on
the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def flash_attention_op(
    q: torch.Tensor,               # (B, S, H, hd) — model layout
    k: torch.Tensor,               # (B, S, Kv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """(B, S, H, hd) attention output: the CUDA kernel for card tensors,
    the plain version for CPU tensors."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention(qt, kt, vt, causal=causal, window=window, out=out.transpose(1, 2))
    return out
