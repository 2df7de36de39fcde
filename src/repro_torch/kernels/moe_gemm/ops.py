"""The model's grouped expert GEMM: the counterpart of the reference's
``moe_gemm/ops.py``.  The MoE FFN's dispatch buffers and expert weights go
to the wrapper as contiguous tensors."""

from __future__ import annotations

import torch

from .grouped_gemm import grouped_gemm


def grouped_gemm_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (E, C, D) @ w (E, D, F) -> (E, C, F)``: the CUDA kernel for card
    tensors, the plain version for CPU tensors."""
    return grouped_gemm(x.contiguous(), w.contiguous())
