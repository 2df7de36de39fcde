"""Shared model utilities: parameter specs (the one source of shapes and
initializers), RMS norm, RoPE and dtype names.

Torch counterpart of ``repro/models/common.py``.  The scan-unroll switch and
the logical sharding axes of the reference serve XLA's cost probes and
sharding and have no counterpart here: layers are a plain ``nn.ModuleList``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

# A ParamSpec maps param name -> (shape, logical_axes, init), exactly as the
# reference's; init is "normal" (trunc-normal, std 0.02), "zeros", "ones",
# or a float std.
ParamSpec = Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...], Any]]


def init_tensor(shape, init, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """One parameter as the reference's ``init_from_spec`` makes it: zeros,
    ones, or a normal truncated at ±2σ and scaled by σ (0.02 for
    "normal").  Drawn on the generator's device; the numbers differ from
    ``jax.random``'s."""
    dev = generator.device
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    std = 0.02 if init == "normal" else float(init)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


# -- norms ------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


# -- rotary embeddings ---------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) integer.
    Rotate-half on the split halves, angles in f32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                  # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# -- misc ------------------------------------------------------------------------------
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]

