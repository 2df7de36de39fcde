"""Residual blocks: one spec + forward + decode step per block kind.

Torch counterpart of ``repro/models/blocks.py`` for the attention kinds:
"attn" (global) and "local" (sliding window), each with a dense SwiGLU FFN
or, when the config has experts, an MoE FFN.  The recurrent kinds are later
slices of the port and raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from .common import ParamSpec, rms_norm

ATTENTION_KINDS = ("attn", "local")

#: Block kinds of later slices, with the ROADMAP.md §1 item that ports them.
_LATER_SLICES = {
    "rglru": "recurrentgemma-9b (rglru_scan)",
    "mlstm": "xlstm-350m (mlstm_chunk)",
    "slstm": "xlstm-350m (mlstm_chunk)",
}


def check_supported(cfg: ModelConfig, kind: str) -> None:
    if kind in _LATER_SLICES:
        raise NotImplementedError(
            f"{cfg.arch}: block kind {kind!r} is not ported yet; it comes with the "
            f"slice {_LATER_SLICES[kind]} of ROADMAP.md §1"
        )
    if kind not in ATTENTION_KINDS:
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
) -> Tuple[torch.Tensor, attn.Cache, Union[torch.Tensor, float]]:
    """Full-sequence pass.  Returns (x, decode cache, aux loss)."""
    mixed, cache = attn.attention_forward(
        cfg, p, rms_norm(x, p["ln1"]), positions,
        window=_window(cfg, kind), causal=causal,
    )
    x, stats = _mix_ffn(cfg, p, x, mixed)
    # The MoE's load-balancing loss (an f32 scalar), else 0.0 (no device work).
    return x, cache, moe_mod.moe_aux(cfg, *stats) if stats else 0.0


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device) -> attn.Cache:
    return attn.init_kv_cache(cfg, batch, max_seq, _window(cfg, kind), dtype, device)


def block_decode(
    cfg: ModelConfig,
    kind: str,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,            # (B, 1, D)
    cache: attn.Cache,
    pos: int,
) -> Tuple[torch.Tensor, attn.Cache]:
    mixed, cache = attn.attention_decode(
        cfg, p, rms_norm(x, p["ln1"]), cache, pos, window=_window(cfg, kind),
    )
    x, _ = _mix_ffn(cfg, p, x, mixed)
    return x, cache
