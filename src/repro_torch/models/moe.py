"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch into
capacity-bounded grouped GEMMs (GShard-style, with token dropping).

Torch counterpart of ``repro/models/moe.py`` (``moe_spec``,
``moe_capacity``, ``moe_forward_global``, the reference's default path).
The three expert contractions go through ``grouped_gemm_op``: on card
tensors the CUDA grouped-GEMM kernel, on CPU tensors its plain version.
The reference's per-row dispatch (``moe_forward_grouped``, a sharding
layout for meshes) is not ported.

Where the port matches the reference's choices exactly:

* top-k: ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; a stable descending sort does the same (``torch.topk``
  does not promise it, and ties are common with bf16 logits);
* dispatch: slots sorted by expert with a stable sort, so the rank within
  an expert follows token order and capacity is shared by the whole batch,
  its last tokens dropped first;
* combine: each token's weighted expert rows are added in the compute
  dtype in ascending expert order (the order of the sorted slots), one term
  at a time, with no atomics.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.moe_gemm import grouped_gemm_op
from .common import ParamSpec


def moe_spec(cfg: ModelConfig) -> ParamSpec:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ((D, E), ("embed", "experts"), "normal"),
        "wi": ((E, D, Fd), ("experts", "embed", "ffn"), "normal"),
        "wu": ((E, D, Fd), ("experts", "embed", "ffn"), "normal"),
        "wd": ((E, Fd, D), ("experts", "ffn", "embed"), "normal"),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)  # a multiple of 8, as the reference pads


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest along the last axis, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """Router of ``xf (T, D)``: ``(probs (T, E) f32, gates (T, K)
    renormalized, expert indices (T, K))``."""
    logits = (xf @ router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, cfg.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def moe_aux(cfg: ModelConfig, probs: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch form), an f32 scalar:
    E * sum(me * ce), from the router probabilities and the slots per expert
    that ``moe_forward`` returns."""
    T = probs.shape[0]
    return cfg.n_experts * torch.sum(probs.mean(dim=0) * (counts.float() / (T * cfg.top_k)))


def moe_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), router probabilities (T, E) f32, slots
    per expert (E,)).  ``moe_aux`` makes the reference's aux loss of the last
    two; a decode step, which drops the loss, does not compute it."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = moe_capacity(cfg, T)
    dt, dev = x.dtype, x.device
    xf = x.reshape(T, D)

    probs, gates, experts = route(cfg, p["router"], xf)

    # Slots per expert.  Counts are integers, so the order of the scatter's
    # adds does not matter.
    flat_expert = experts.reshape(-1)                                   # (T*K,)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))

    # Rank of each slot within its expert, slots taken in token order.
    order = torch.argsort(flat_expert, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_expert)
    rank[order] = torch.arange(T * K, device=dev) - starts[flat_expert[order]]
    keep = rank < C                                                     # beyond capacity: dropped
    slot = flat_expert * C + torch.where(keep, rank, 0)

    # Dispatch: each kept slot is written once (exact in any order); dropped
    # slots go to a spare row past the buffer.
    buf = torch.zeros(E * C + 1, D, dtype=dt, device=dev)
    token = torch.arange(T, device=dev).repeat_interleave(K)
    buf.index_copy_(0, torch.where(keep, slot, E * C), xf[token])
    xe = buf[: E * C].view(E, C, D)

    # Grouped expert FFN (SwiGLU): silu in f32, cast to the compute dtype.
    h = grouped_gemm_op(xe, p["wi"])
    u = grouped_gemm_op(xe, p["wu"])
    y = F.silu(h.float()).to(dt) * u
    ye = grouped_gemm_op(y, p["wd"]).view(E * C, D)

    # Combine: a token's K terms in ascending expert order, added in dt.
    by_expert = torch.argsort(experts, dim=-1)                          # (T, K)
    slot_tk = slot.view(T, K).gather(1, by_expert)
    gate_tk = torch.where(keep.view(T, K), gates, 0.0).gather(1, by_expert).to(dt)
    out = ye[slot_tk[:, 0]] * gate_tk[:, :1]
    for k in range(1, K):
        out = out + ye[slot_tk[:, k]] * gate_tk[:, k:k + 1]
    return out.view(B, S, D), probs, counts
