"""GQA self-attention: full-causal, sliding-window and bidirectional;
forward (train/prefill) and single-token decode against a KV cache.

Torch counterpart of ``repro/models/attention.py``.  Every self-attention
goes through the kernel ops: ``flash_attention_op`` for the forward pass
(the reference's ``_sdpa`` and ``_sdpa_blocked`` are one function, which the
flash kernel computes) and ``decode_attention_op`` for decode.  On card
tensors they launch the CUDA kernels, on CPU tensors they take the plain
versions.  Scores
are f32, as in the kernels (the reference's ``_sdpa`` forms them in the
compute dtype).  Cross-attention (whisper) is a later slice.

The decode path writes the new token's k and v into the cache in place and
returns the same dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attention_op
from ..kernels.flash import flash_attention_op
from .common import ParamSpec, apply_rope, rms_norm

#: An attention layer's decode cache: its k and v buffers.
KVCache = Dict[str, torch.Tensor]


def attn_spec(cfg: ModelConfig) -> ParamSpec:
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec: ParamSpec = {
        "wq": ((D, H * hd), ("embed", "q_heads"), "normal"),
        "wk": ((D, Kv * hd), ("embed", "kv_heads"), "normal"),
        "wv": ((D, Kv * hd), ("embed", "kv_heads"), "normal"),
        "wo": ((H * hd, D), ("q_heads", "embed"), "normal"),
    }
    if cfg.qk_norm:
        spec["q_norm"] = ((hd,), (None,), "ones")
        spec["k_norm"] = ((hd,), (None,), "ones")
    return spec


def _project_qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor):
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).view(B, S, H, hd)
    k = (x @ p["wk"]).view(B, S, Kv, hd)
    v = (x @ p["wv"]).view(B, S, Kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def attention_forward(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: Optional[int] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, KVCache]:
    """Full-sequence attention.  Returns (out (B,S,D), kv cache pieces)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention_op(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, -1) @ p["wo"]
    # Cache for decode continuation: ring-buffered if windowed, rolled so
    # that slot (pos % window) holds position pos.
    if window is not None and S > window:
        shift = S % window
        k, v = (t[:, -window:].roll(shift, dims=1) for t in (k, v))
    return out, {"k": k, "v": v}


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, window: Optional[int],
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    S = min(window, max_seq) if window else max_seq
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,            # (B, 1, D)
    cache: KVCache,
    pos: int,                   # index of the new token
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)
    pos_arr = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    S = cache["k"].shape[1]
    # Full cache: the slot clamps at S - 1.  Ring buffer: slot pos % S.  In
    # both layouts the positions to attend to are the first min(pos + 1, S)
    # rows — exactly the reference's mask.
    slot = pos % S if window else min(pos, S - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    out = decode_attention_op(q, cache["k"], cache["v"], min(pos + 1, S))
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, cache
