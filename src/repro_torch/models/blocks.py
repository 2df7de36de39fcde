"""Residual blocks: one spec + forward + decode step per block kind.

Torch counterpart of ``repro/models/blocks.py`` for the attention kinds,
"attn" (global) and "local" (sliding window), each with a dense SwiGLU FFN
or, when the config has experts, an MoE FFN; and for the recurrent kind
"rglru" (Griffin's RG-LRU) with its SwiGLU FFN.  The xLSTM kinds ("mlstm",
"slstm") are a later slice of the port and raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from .common import ParamSpec, rms_norm

ATTENTION_KINDS = ("attn", "local")
KINDS = ATTENTION_KINDS + ("rglru",)

#: A layer's decode cache: an attention layer's KV buffers ("k", "v") or a
#: recurrent layer's state ("h", "conv").
LayerCache = Dict[str, torch.Tensor]

#: Block kinds of later slices, with the ROADMAP.md §1 item that ports them.
_LATER_SLICES = {
    "mlstm": "xlstm-350m (mlstm_chunk)",
    "slstm": "xlstm-350m (mlstm_chunk)",
}


def check_supported(cfg: ModelConfig, kind: str) -> None:
    if kind in _LATER_SLICES:
        raise NotImplementedError(
            f"{cfg.arch}: block kind {kind!r} is not ported yet; it comes with the "
            f"slice {_LATER_SLICES[kind]} of ROADMAP.md §1"
        )
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def ffn_spec(cfg: ModelConfig) -> ParamSpec:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "wi": ((D, Fd), ("embed", "ffn"), "normal"),
        "wu": ((D, Fd), ("embed", "ffn"), "normal"),
        "wd": ((Fd, D), ("ffn", "embed"), "normal"),
    }


def ffn_forward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu in f32, cast to the compute dtype, times the up branch."""
    h = x @ p["wi"]
    u = x @ p["wu"]
    return (F.silu(h.float()).to(x.dtype) * u) @ p["wd"]


def block_spec(cfg: ModelConfig, kind: str) -> ParamSpec:
    check_supported(cfg, kind)
    D = cfg.d_model
    spec: ParamSpec = {"ln1": ((D,), ("embed",), "ones")}
    if kind == "rglru":
        spec.update(rec.rglru_spec(cfg))
        if cfg.d_ff > 0:
            spec["ln2"] = ((D,), ("embed",), "ones")
            spec.update(ffn_spec(cfg))
        return spec
    spec.update(attn.attn_spec(cfg))
    if cfg.n_experts > 0:
        spec["ln2"] = ((D,), ("embed",), "ones")
        spec.update(moe_mod.moe_spec(cfg))
    elif cfg.d_ff > 0:
        spec["ln2"] = ((D,), ("embed",), "ones")
        spec.update(ffn_spec(cfg))
    return spec


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window if kind == "local" else None


def _mix_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
             mixed: torch.Tensor) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Residual-add the mixer's output, then the (Mo)FFN if there is one.
    Returns (x, the MoE's router probabilities and slots per expert, or None
    for blocks without experts)."""
    stats = None
    x = x + mixed
    if "ln2" in p:
        h = rms_norm(x, p["ln2"])
        if "router" in p:
            f, probs, counts = moe_mod.moe_forward(cfg, p, h)
            stats = (probs, counts)
        else:
            f = ffn_forward(p, h)
        x = x + f
    return x, stats


def block_forward(
    cfg: ModelConfig,
    kind: str,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, LayerCache, Union[torch.Tensor, float]]:
    """Full-sequence pass.  Returns (x, decode cache, aux loss)."""
    h = rms_norm(x, p["ln1"])
    if kind == "rglru":
        mixed, cache = rec.rglru_forward(cfg, p, h)
    else:
        mixed, cache = attn.attention_forward(
            cfg, p, h, positions, window=_window(cfg, kind), causal=causal,
        )
    x, stats = _mix_ffn(cfg, p, x, mixed)
    # The MoE's load-balancing loss (an f32 scalar), else 0.0 (no device work).
    return x, cache, moe_mod.moe_aux(cfg, *stats) if stats else 0.0


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device) -> LayerCache:
    if kind == "rglru":
        return rec.rglru_init_state(cfg, batch, device)
    return attn.init_kv_cache(cfg, batch, max_seq, _window(cfg, kind), dtype, device)


def block_decode(
    cfg: ModelConfig,
    kind: str,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,            # (B, 1, D)
    cache: LayerCache,
    pos: int,
) -> Tuple[torch.Tensor, LayerCache]:
    """One token; the layer's cache is updated in place."""
    h = rms_norm(x, p["ln1"])
    if kind == "rglru":
        mixed, cache = rec.rglru_step(cfg, p, h, cache)
    else:
        mixed, cache = attn.attention_decode(cfg, p, h, cache, pos, window=_window(cfg, kind))
    x, _ = _mix_ffn(cfg, p, x, mixed)
    return x, cache
