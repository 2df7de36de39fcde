"""The model's RG-LRU scan: the counterpart of the reference's
``rglru/ops.py``.  The recurrent block's gates and gated inputs go to the
wrapper as contiguous tensors."""

from __future__ import annotations

import torch

from .rglru_scan import rglru_scan


def rglru_scan_op(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + x_t`` over ``(B, S, D)`` from ``h0 (B, D)``:
    the CUDA kernel for card tensors, the plain version for CPU tensors."""
    return rglru_scan(a.contiguous(), x.contiguous(), h0.contiguous())
