"""Grouped expert GEMM: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_gg_kernel`` of
``repro/kernels/moe_gemm/grouped_gemm.py``.  ``x (E, C, D) @ w (E, D, F) ->
(E, C, F)`` expert by expert, sums over D in f32, output in x's dtype.

* ``grouped_gemm(x, w)`` is the wrapper.  For tensors on the card it
  launches ``csrc/grouped_gemm.cu`` (one block per output tile and expert,
  walking all of D; tensor cores in bf16, f32 FMAs in f32; built at first
  use for ``sm_90a``) and adds one to ``grouped_gemm.launches``.  Any C, D
  and F are taken (ragged tiles are masked); both inputs must be
  contiguous.  For tensors on the CPU it takes the plain version.  There is
  no fallback from the card to the plain version.
* ``grouped_gemm_plain(x, w)`` is the plain PyTorch version: the
  reference's ``grouped_gemm_ref``, an f32 einsum cast to x's dtype, on any
  device.

What bounds the kernel on an H100: operations at prefill (C in the
thousands), bytes at decode (C = 8: the expert weights, read once).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..launch import check_card_inputs, launch

#: Largest grid y and z extent: tiles of C (64 rows at the least), experts.
MAX_GRID_YZ = 65535

_PTR_FIELDS = ("x", "w", "y")
_INT_FIELDS = ("E", "C", "D", "F", "dtype")


class _GroupedGemmArgs(ctypes.Structure):
    """Mirror of ``struct GroupedGemmArgs`` in ``csrc/grouped_gemm.cu``."""

    _fields_ = [(n, ctypes.c_void_p) for n in _PTR_FIELDS] + [(n, ctypes.c_int) for n in _INT_FIELDS]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ...build import load_library  # builds csrc/grouped_gemm.cu at first use

    lib = load_library("grouped_gemm")
    lib.grouped_gemm_launch.argtypes = [ctypes.POINTER(_GroupedGemmArgs), ctypes.c_void_p]
    lib.grouped_gemm_launch.restype = ctypes.c_int
    return lib


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)} against w {tuple(w.shape)}; "
                         "want (E,C,D) and (E,D,F)")


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(E, C, F)`` expert-wise products; the CUDA kernel for card tensors,
    the plain version for CPU tensors."""
    _check_shapes(x, w)
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: tensors on {x.device}; use a CUDA device or the CPU")
    dtype = check_card_inputs("grouped_gemm", x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_gemm: the kernel needs contiguous x and w")
    E, C, D = x.shape
    F = w.shape[2]
    if max(E, -(-C // 64)) > MAX_GRID_YZ or max(C, D, F) >= 2**31:
        raise ValueError(f"grouped_gemm: shape {(E, C, D, F)} exceeds the kernel's grid")
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    args = _GroupedGemmArgs(x=x.data_ptr(), w=w.data_ptr(), y=y.data_ptr(),
                            E=E, C=C, D=D, F=F, dtype=dtype)
    launch("grouped_gemm", _library().grouped_gemm_launch, args, x.device)
    grouped_gemm.launches += 1
    return y


grouped_gemm.launches = 0


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version on the same inputs: an f32 einsum, cast to
    x's dtype (the reference's ``grouped_gemm_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
