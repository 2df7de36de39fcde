"""Flash attention: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash/flash_attention.py``.  Layout as the reference's
kernels package: q ``(B, H, Sq, hd)``, k and v ``(B, Kv, Sk, hd)``, output
``(B, H, Sq, hd)`` in q's dtype; query head ``h`` reads kv head
``h // (H // Kv)``.  ``causal`` masks ``j <= i`` (offset 0, so Sq == Sk),
``window`` further keeps ``j > i - window``; without ``causal`` every key
is seen and ``window`` is ignored, as in the reference.

* ``flash_attention(q, k, v, ...)`` is the wrapper.  For tensors on the
  card it launches ``csrc/flash_attention.cu`` (one block per 64-row q tile
  and head, f32 online softmax; built at first use for ``sm_90a``) and adds
  one to ``flash_attention.launches``; any strides with a unit innermost
  stride are taken as they are, so model-layout views need no copy.  For
  tensors on the CPU it takes the plain version.  There is no fallback from
  the card to the plain version.
* ``flash_attention_plain(q, k, v, ...)`` is the plain PyTorch version: the
  reference's ``attention_ref`` in f32 on any device.

What bounds the kernel on an H100: operations (about ``4 · hd`` per
unmasked query-key pair against a few bytes per row); this first version
runs f32 FMAs from shared memory, far below the tensor-core rate.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..launch import MAX_HEAD_DIM, check_card_inputs, launch

NEG_INF = -1e30

_PTR_FIELDS = ("q", "k", "v", "o")
_STRIDE_FIELDS = tuple(f"{t}_s{a}" for t in "qkvo" for a in "bhs")
_INT_FIELDS = ("B", "H", "Kv", "Sq", "Sk", "hd", "causal", "window", "dtype")


class _FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in ``csrc/flash_attention.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in _PTR_FIELDS]
        + [(n, ctypes.c_longlong) for n in _STRIDE_FIELDS]
        + [("scale", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in _INT_FIELDS]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ...build import load_library  # builds csrc/flash_attention.cu at first use

    lib = load_library("flash_attention")
    lib.flash_attention_launch.argtypes = [ctypes.POINTER(_FlashArgs), ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want (B,H,Sq,hd) and (B,Kv,Sk,hd)")
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kv < 1 or H % Kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k {tuple(k.shape)}")
    if causal and Sq != Sk:
        raise ValueError(f"flash_attention: causal masking assumes Sq == Sk, got {Sq} and {Sk}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention in kernel layout; the CUDA kernel for card tensors, the
    plain version for CPU tensors.  ``out``, if given, is a ``(B, H, Sq,
    hd)`` tensor or view to write into."""
    _check_shapes(q, k, v, causal, window)
    if out is not None and out.shape != q.shape:
        raise ValueError(f"flash_attention: out {tuple(out.shape)}, want {tuple(q.shape)}")
    if q.device.type == "cpu":
        result = flash_attention_plain(q, k, v, causal=causal, window=window)
        return result if out is None else out.copy_(result)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device}; use a CUDA device or the CPU")
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    dtype = check_card_inputs("flash_attention", q, k, v, out)
    if Sq == 0:
        return out
    args = _FlashArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=out.data_ptr(),
        scale=1.0 / math.sqrt(hd), B=B, H=H, Kv=Kv, Sq=Sq, Sk=Sk, hd=hd,
        causal=int(causal), window=int(window or 0), dtype=dtype,
    )
    for name, t in zip("qkvo", (q, k, v, out)):
        for axis, stride in zip("bhs", t.stride()[:3]):
            setattr(args, f"{name}_s{axis}", stride)
    launch("flash_attention", _library().flash_attention_launch, args, q.device)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version on the same inputs: scores, mask and
    softmax in f32 over the whole key row (the reference's
    ``attention_ref``), output in q's dtype."""
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Kv, G, Sq, hd).float()
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        i = torch.arange(Sq, device=q.device)[:, None]
        j = torch.arange(Sk, device=q.device)[None, :]
        mask = j <= i
        if window is not None:
            mask = mask & (j > i - window)
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)
