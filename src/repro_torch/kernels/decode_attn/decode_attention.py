"""Decode attention: the hand-written CUDA kernels and their plain version.

Replaces the TPU kernel ``_decode_kernel`` of
``repro/kernels/decode_attn/decode_attention.py``.  One query token per
head, q ``(B, H, hd)``, attends to the first ``length`` rows of a KV cache k,
v ``(B, Kv, S, hd)``; query head ``h`` reads kv head ``h // (H // Kv)``.
Output ``(B, H, hd)`` in q's dtype.

* ``decode_attention(q, k, v, length)`` is the wrapper.  For tensors on the
  card it launches ``csrc/decode_attention.cu`` — split-K flash decoding: a
  partial kernel whose warps each walk one split of the cache rows, then a
  combine kernel per ``(b, h)`` — and adds one to
  ``decode_attention.launches``.  ``length`` is a Python int or an int32
  scalar on the card (read there, so no host sync); it is clamped to S and
  must be at least 1.  Strided views with a unit innermost stride are taken
  as they are.  For tensors on the CPU it takes the plain version.  There
  is no fallback from the card to the plain version.
* ``decode_attention_plain(q, k, v, length)`` is the plain PyTorch version:
  the reference's ``decode_attention_ref`` in f32 on any device.

What bounds the kernel on an H100: bytes — every K and V row below
``length`` read once.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple, Union

import torch

from ..launch import MAX_HEAD_DIM, check_card_inputs, launch

NEG_INF = -1e30

#: Largest kv group (H // Kv) the kernel is instantiated for.
MAX_GROUP = 16
#: Most splits of the cache rows (the combine kernel's shared table).
MAX_SPLITS = 256
#: Splits are sized so that about this many warps walk the cache at once.
TARGET_WARPS = 4096
#: Fewest cache rows per split.
MIN_SPLIT_ROWS = 32

Length = Union[int, torch.Tensor]

_PTR_FIELDS = ("q", "k", "v", "length_ptr", "part_m", "part_l", "part_acc", "o")
_STRIDE_FIELDS = ("q_sb", "q_sh", "k_sb", "k_sh", "k_ss", "v_sb", "v_sh", "v_ss", "o_sb", "o_sh")
_INT_FIELDS = ("B", "H", "Kv", "S", "hd", "length", "n_split", "split_rows", "dtype")


class _DecodeArgs(ctypes.Structure):
    """Mirror of ``struct DecodeArgs`` in ``csrc/decode_attention.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in _PTR_FIELDS]
        + [(n, ctypes.c_longlong) for n in _STRIDE_FIELDS]
        + [("scale", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in _INT_FIELDS]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ...build import load_library  # builds csrc/decode_attention.cu at first use

    lib = load_library("decode_attention")
    lib.decode_attention_launch.argtypes = [ctypes.POINTER(_DecodeArgs), ctypes.c_void_p]
    lib.decode_attention_launch.restype = ctypes.c_int
    return lib


def split_plan(B: int, Kv: int, S: int) -> Tuple[int, int]:
    """``(n_split, split_rows)``: the cache rows cut into splits of at least
    ``MIN_SPLIT_ROWS`` rows, enough of them that about ``TARGET_WARPS``
    warps run, and at most ``MAX_SPLITS``.  Fixed by the cache size, not by
    ``length``, so a device-side length needs no host sync."""
    want = max(1, -(-TARGET_WARPS // (B * Kv)))
    n_split = min(want, -(-S // MIN_SPLIT_ROWS), MAX_SPLITS)
    split_rows = -(-S // n_split)
    return -(-S // split_rows), split_rows


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want (B,H,hd) and (B,Kv,S,hd)")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[1] < 1 or H % k.shape[1]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against k {tuple(k.shape)}")


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    length: Length,
) -> torch.Tensor:
    """Decode attention; the CUDA kernels for card tensors, the plain
    version for CPU tensors."""
    _check_shapes(q, k, v)
    if isinstance(length, int) and length < 1:
        raise ValueError(f"decode_attention: length must be >= 1, got {length}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: tensors on {q.device}; use a CUDA device or the CPU")
    B, H, hd = q.shape
    Kv, S = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {hd} > {MAX_HEAD_DIM}")
    if H // Kv > MAX_GROUP:
        raise ValueError(f"decode_attention: kv group {H // Kv} > {MAX_GROUP}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    dtype = check_card_inputs("decode_attention", q, k, v, out)
    length_ptr = None
    if isinstance(length, torch.Tensor):
        if length.device != q.device or length.dtype != torch.int32 or length.numel() != 1:
            raise ValueError("decode_attention: a tensor length must be one int32 on q's device")
        length_ptr = length.data_ptr()
    n_split, split_rows = split_plan(B, Kv, S)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty(n_split, B, H, **f32)
    part_l = torch.empty(n_split, B, H, **f32)
    part_acc = torch.empty(n_split, B, H, hd, **f32)
    args = _DecodeArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), length_ptr=length_ptr,
        part_m=part_m.data_ptr(), part_l=part_l.data_ptr(), part_acc=part_acc.data_ptr(),
        o=out.data_ptr(),
        q_sb=q.stride(0), q_sh=q.stride(1),
        k_sb=k.stride(0), k_sh=k.stride(1), k_ss=k.stride(2),
        v_sb=v.stride(0), v_sh=v.stride(1), v_ss=v.stride(2),
        o_sb=out.stride(0), o_sh=out.stride(1),
        scale=1.0 / math.sqrt(hd), B=B, H=H, Kv=Kv, S=S, hd=hd,
        length=length if length_ptr is None else 0,
        n_split=n_split, split_rows=split_rows, dtype=dtype,
    )
    launch("decode_attention", _library().decode_attention_launch, args, q.device)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: Length
) -> torch.Tensor:
    """The plain PyTorch version on the same inputs: scores, mask
    (``position < length``) and softmax in f32 (the reference's
    ``decode_attention_ref``), output in q's dtype."""
    B, H, hd = q.shape
    Kv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Kv, H // Kv, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k.float()) / math.sqrt(hd)
    mask = torch.arange(S, device=q.device) < torch.as_tensor(length, device=q.device)
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", w, v.float())
    return out.reshape(B, H, hd).to(q.dtype)
