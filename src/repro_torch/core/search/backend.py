"""Device gate for the batched search subsystem.

The reference dispatches between jax (scoped float64) and numpy; the port
runs one set of torch ops on an explicit device instead.  Every search
tensor is created with ``dtype=torch.float64`` (placements ``int64``), so
there is no global dtype switch to scope.  ``resolve_device`` (the port's
device gate, :mod:`repro_torch.device`) is re-exported here.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ...device import DeviceLike, resolve_device  # noqa: F401  (re-exported)


def chunk_ranges(n: int, chunk: int) -> Iterator[Tuple[int, int]]:
    """Yield ``(lo, hi)`` slice bounds covering ``range(n)`` in ``chunk``
    steps — the one chunking loop every evaluator path shares, so the
    "results independent of chunking" contract has a single implementation."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for lo in range(0, n, chunk):
        yield lo, min(lo + chunk, n)


def as_tensor(a, device: Optional[torch.device]) -> torch.Tensor:
    """Upload one compiled numpy array: float64 stays float64, integer index
    arrays become int64, bool masks stay bool."""
    t = torch.as_tensor(a)
    if t.dtype.is_floating_point:
        t = t.to(torch.float64)
    elif t.dtype != torch.bool:
        t = t.to(torch.int64)
    return t.to(device).contiguous()
