"""RG-LRU scan: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_rglru_kernel`` of
``repro/kernels/rglru/rglru_scan.py``.  The diagonal linear recurrence
``h_t = a_t * h_{t-1} + x_t`` over a and x ``(B, S, D)`` from ``h0 (B, D)``,
in f32, output ``(B, S, D)`` in x's dtype.

* ``rglru_scan(a, x, h0)`` is the wrapper.  For tensors on the card it
  launches ``csrc/rglru_scan.cu`` (one block per 32 channels of a batch row,
  walking the whole sequence in 128-step tiles with the carry in registers;
  built at first use for ``sm_90a``) and adds one to ``rglru_scan.launches``.
  a and x are float32 or bfloat16 (one dtype), h0 is float32; all three
  must be contiguous.  Any S and D are taken (the reference asserts that
  its time block divides S).  For tensors on the CPU it takes the plain
  version.  There is no fallback from the card to the plain version.
* ``rglru_scan_plain(a, x, h0)`` is the plain PyTorch version: the
  reference's ``rglru_scan_ref``, a sequential loop over time in f32, on any
  device.

What bounds the kernel on an H100: bytes — a and x read once, h written
once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..launch import check_card_inputs, launch

#: Largest grid y extent: batch rows.
MAX_GRID_Y = 65535

_PTR_FIELDS = ("a", "x", "h0", "h")
_INT_FIELDS = ("B", "S", "D", "dtype")


class _RglruArgs(ctypes.Structure):
    """Mirror of ``struct RglruArgs`` in ``csrc/rglru_scan.cu``."""

    _fields_ = [(n, ctypes.c_void_p) for n in _PTR_FIELDS] + [(n, ctypes.c_int) for n in _INT_FIELDS]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ...build import load_library  # builds csrc/rglru_scan.cu at first use

    lib = load_library("rglru_scan")
    lib.rglru_scan_launch.argtypes = [ctypes.POINTER(_RglruArgs), ctypes.c_void_p]
    lib.rglru_scan_launch.restype = ctypes.c_int
    return lib


def _check_shapes(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != x.shape or h0.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, x {tuple(x.shape)}, h0 {tuple(h0.shape)}; "
                         "want (B,S,D), (B,S,D) and (B,D)")


def rglru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``(B, S, D)`` states in x's dtype; the CUDA kernel for card tensors,
    the plain version for CPU tensors."""
    _check_shapes(a, x, h0)
    if x.device.type == "cpu":
        return rglru_scan_plain(a, x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: tensors on {x.device}; use a CUDA device or the CPU")
    dtype = check_card_inputs("rglru_scan", a, x)
    if h0.device != x.device or h0.dtype != torch.float32:
        raise TypeError(f"rglru_scan: h0 is {h0.dtype} on {h0.device}; the kernel takes float32 "
                        f"on {x.device}")
    if not (a.is_contiguous() and x.is_contiguous() and h0.is_contiguous()):
        raise ValueError("rglru_scan: the kernel needs contiguous a, x and h0")
    B, S, D = x.shape
    h = torch.empty_like(x)
    if h.numel() == 0:
        return h
    if B > MAX_GRID_Y or max(S, D) >= 2**31:
        raise ValueError(f"rglru_scan: shape {(B, S, D)} exceeds the kernel's grid")
    args = _RglruArgs(a=a.data_ptr(), x=x.data_ptr(), h0=h0.data_ptr(), h=h.data_ptr(),
                      B=B, S=S, D=D, dtype=dtype)
    launch("rglru_scan", _library().rglru_scan_launch, args, x.device)
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0


def rglru_scan_plain(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version on the same inputs: ``h = a_t * h + x_t``
    one step at a time in f32 from h0, output in x's dtype (the
    reference's ``rglru_scan_ref``)."""
    _check_shapes(a, x, h0)
    a32, x32 = a.float(), x.float()
    h = h0.float()
    hs = []
    for t in range(x.shape[1]):
        h = a32[:, t] * h + x32[:, t]
        hs.append(h)
    if not hs:
        return torch.empty_like(x)
    return torch.stack(hs, dim=1).to(x.dtype)
