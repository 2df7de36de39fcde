"""Pure-functional batched placement objective.

Given an uploaded ``BatchArena`` and a batch of candidate placements as an
int tensor ``(B, T)`` of node indices, return per-candidate

* ``net``        — network cost: inter-node edge traffic × rack distance
  (the quadratic QM3DKP term R-Storm's greedy minimizes implicitly), plus
  — on arenas carrying ``move_base``/``move_cost`` (reconfiguration
  searches) — the per-task migration penalty for every task placed away
  from its pre-rebalance node;
* ``violation``  — total hard-capacity overshoot across nodes and hard
  columns (0.0 ⇔ the candidate respects every hard constraint);
* ``dead``       — count of tasks placed on dead nodes;
* ``throughput`` — the throughput proxy, when a ``ThroughputModel`` is given.

All four come from one call of the fused scorer per chunk
(:mod:`.kernels.fused_score`): the hand-written CUDA kernel on the card,
its plain torch version on the CPU.  Both are exact for the repo's
resource values (net distances are 0.5-multiples; demands and rates are
dyadic), so outputs are bit-identical to the reference's numpy backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Penalty weight folding hard-capacity overshoot into one scalar cost — the
# same constant the sequential annealer uses, so accept thresholds mean the
# same thing in both engines.
from ..engine.annealing import OVERLOAD_PENALTY
from .backend import chunk_ranges
from .batch import BatchArena
from .kernels.fused_score import fused_inputs, fused_score


@dataclasses.dataclass(frozen=True)
class BatchEval:
    """Per-candidate objective terms, tensors on the arena's device."""

    net: torch.Tensor  # (B,) float64
    violation: torch.Tensor  # (B,) float64
    dead: torch.Tensor  # (B,) int64
    # (B,) float64 throughput proxy (tuples/s), populated only when a
    # ThroughputModel was passed to ``evaluate_batch``.
    throughput: Optional[torch.Tensor] = None

    @property
    def feasible(self) -> torch.Tensor:
        """(B,) bool: no hard-capacity overshoot and no dead-node hits."""
        return (self.violation <= 0.0) & (self.dead == 0)

    def penalized(self) -> torch.Tensor:
        """(B,) combined scalar cost (net + penalty × violation)."""
        return self.net + OVERLOAD_PENALTY * self.violation


def as_batch(ba: BatchArena, placements) -> torch.Tensor:
    """A ``(B, T)`` int64 placement batch on the arena's device from a
    tensor or array batch (or one ``(T,)`` row), with its node indices
    checked on the host side of the call: the kernel trusts them."""
    P = torch.as_tensor(placements).to(device=ba.device, dtype=torch.int64)
    if P.dim() == 1:
        P = P[None, :]
    if P.dim() != 2 or P.shape[1] != ba.n_tasks:
        raise ValueError(
            f"placement batch has shape {tuple(P.shape)}, arena has {ba.n_tasks} tasks"
        )
    if P.numel() and bool(((P < 0) | (P >= ba.n_nodes)).any()):
        raise ValueError(f"placement batch holds node indices outside [0, {ba.n_nodes})")
    return P.contiguous()


def evaluate_batch(
    ba: BatchArena,
    placements,
    chunk: int = 256,
    throughput_model=None,
) -> BatchEval:
    """Score a batch of candidate placements ``(B, T)`` (or one ``(T,)`` row)
    on the uploaded arena's device.

    ``chunk`` bounds the per-call working set (the (chunk, E) edge gather of
    the plain version, one kernel launch each on the card); results are
    independent of the chunking.  Passing an uploaded ``ThroughputModel``
    also populates ``BatchEval.throughput`` with the per-candidate proxy.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    P = as_batch(ba, placements)
    inputs = fused_inputs(ba, throughput_model)
    parts = [fused_score(inputs, P[lo:hi]) for lo, hi in chunk_ranges(P.shape[0], chunk)]
    if not parts:  # an empty batch still yields (0,) terms of the right dtypes
        parts = [fused_score(inputs, P)]
    net, viol, dead, tp = (
        None if part[0] is None else torch.cat(part) for part in zip(*parts)
    )
    return BatchEval(net=net, violation=viol, dead=dead, throughput=tp)
