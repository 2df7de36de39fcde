"""Recurrent sequence mixer: the RG-LRU block of Griffin / RecurrentGemma
(arXiv:2402.19427 §2.4), a forward (prefill) and a one-token step (decode)
with its state initializer.

Torch counterpart of the RG-LRU part of ``repro/models/recurrent.py``.  The
forward's diagonal recurrence goes through ``rglru_scan_op``: on card tensors
it launches the CUDA kernel, on CPU tensors it takes the plain version (the
reference computes it with ``jax.lax.associative_scan``, so the two agree to
rounding).  The step does its one update in plain arithmetic, as the
reference's does, and launches no kernel.  Its state ``{"h": (B, D) f32,
"conv": (B, 3, D)}`` is updated in place.  The mLSTM and sLSTM mixers
(xLSTM) are a later slice of the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rglru import rglru_scan_op
from .common import ParamSpec

State = Dict[str, torch.Tensor]

_RGLRU_C = 8.0


def rglru_spec(cfg: ModelConfig) -> ParamSpec:
    D = cfg.d_model
    return {
        "w_in_x": ((D, D), ("embed", "ffn_in"), "normal"),
        "w_in_gate": ((D, D), ("embed", "ffn_in"), "normal"),
        "conv_w": ((4, D), (None, "ffn_in"), "normal"),
        "conv_b": ((D,), ("ffn_in",), "zeros"),
        "w_rec_gate": ((D, D), ("embed", "ffn_in"), "normal"),
        "b_rec_gate": ((D,), ("ffn_in",), "zeros"),
        "w_inp_gate": ((D, D), ("embed", "ffn_in"), "normal"),
        "b_inp_gate": ((D,), ("ffn_in",), "zeros"),
        "lambda_p": ((D,), ("ffn_in",), 1.0),
        "w_out": ((D, D), ("ffn_in", "embed"), "normal"),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _rglru_gates(p: Dict[str, torch.Tensor], xb: torch.Tensor,
                 x_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a (the recurrence weight, in (0, 1)) and the gated input, per
    channel, both f32."""
    r = torch.sigmoid((x_raw @ p["w_rec_gate"]).float() + p["b_rec_gate"].float())
    i = torch.sigmoid((x_raw @ p["w_inp_gate"]).float() + p["b_inp_gate"].float())
    log_a = -_RGLRU_C * F.softplus(p["lambda_p"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xb.float())
    return a, gated


def _causal_conv4(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width 4 in the compute dtype, its taps summed
    in order from 0 as Python's ``sum`` does in the reference.  x (B, S, D);
    ``state`` (B, 3, D) carries the last 3 inputs for decode.  Returns (out,
    the last 3 inputs)."""
    if state is not None:
        x_ext = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, 3, 0))
    w = p["conv_w"].to(x.dtype)
    S = x.shape[1]
    out = sum(x_ext[:, i:i + S] * w[i] for i in range(4))
    return out + p["conv_b"].to(x.dtype), x_ext[:, -3:]


def rglru_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """Griffin recurrent block: the in-projection pair, conv4, the RG-LRU
    scan, the GeLU gate and the out-projection.  Returns (out, decode
    state); the state is new tensors, not views of the forward's."""
    xb = x @ p["w_in_x"]
    gate = _gelu((x @ p["w_in_gate"]).float())
    xb, conv_state = _causal_conv4(p, xb)
    a, gated = _rglru_gates(p, xb, x)
    B, _, D = gated.shape
    h = rglru_scan_op(a, gated, torch.zeros(B, D, dtype=torch.float32, device=x.device))
    out = (h * gate).to(x.dtype) @ p["w_out"]
    return out, {"h": h[:, -1].clone(), "conv": conv_state.clone()}


def rglru_init_state(cfg: ModelConfig, batch: int, device: torch.device) -> State:
    D = cfg.d_model
    return {
        "h": torch.zeros((batch, D), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 3, D), dtype=torch.float32, device=device),
    }


def rglru_step(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               state: State) -> Tuple[torch.Tensor, State]:
    """One token, x (B, 1, D).  Writes the new ``h`` and ``conv`` into
    ``state`` in place and returns (out, state)."""
    xb = x @ p["w_in_x"]
    gate = _gelu((x @ p["w_in_gate"]).float())
    xb, conv_state = _causal_conv4(p, xb, state["conv"])
    a, gated = _rglru_gates(p, xb, x)
    h = a[:, 0] * state["h"] + gated[:, 0]
    out = (h[:, None] * gate).to(x.dtype) @ p["w_out"]
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return out, state
