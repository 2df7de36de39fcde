"""What the LM kernels' wrappers share: the dtypes the CUDA sources
are instantiated for, the input checks, and the launch on PyTorch's current
stream with the returned ``cudaError_t`` turned into an exception."""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

#: dtype -> the ``dtype`` code of the kernels' argument structs.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Largest head dim the attention kernels pad to.
MAX_HEAD_DIM = 256


def check_card_inputs(name: str, *tensors: torch.Tensor) -> int:
    """Raise unless the tensors share one CUDA device and a kernel dtype and
    have unit innermost stride; return the dtype code."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {first.dtype} and {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: innermost stride {t.stride(-1)}, the kernel needs 1")
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {first.dtype}; the kernel takes float32 or bfloat16")
    return DTYPE_CODES[first.dtype]


def launch(name: str, fn: Callable, args: ctypes.Structure, device: torch.device) -> None:
    """Call a C launch function on the device's current stream; raise on a
    non-zero ``cudaError_t`` (a refused launch never runs)."""
    with torch.cuda.device(device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
