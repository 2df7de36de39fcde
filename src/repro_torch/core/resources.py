"""Resource vectors with hard/soft constraint classes (paper §3, §4).

A demand or availability is a point in R^n (n = 3 in the paper: memory,
CPU, bandwidth).  Memory is a *hard* constraint — it must never be
violated; CPU and bandwidth are *soft* — they may be overloaded, and each
soft dimension carries a user weight used by the distance function
(Alg 4).  The representation generalizes to any number of named
dimensions so the TPU placement layer can reuse it (HBM hard; FLOP/s and
ICI/DCN bandwidth soft).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping

# Canonical paper dimensions.
MEMORY = "memory_mb"
CPU = "cpu_points"
BANDWIDTH = "bandwidth"

DEFAULT_HARD = frozenset({MEMORY})
DEFAULT_WEIGHTS: Mapping[str, float] = {MEMORY: 1.0, CPU: 1.0, BANDWIDTH: 1.0}


@dataclasses.dataclass(frozen=True)
class ResourceVector:
    """An immutable point in resource space.

    ``values`` maps dimension name -> amount.  ``hard`` names the subset of
    dimensions that are hard constraints (H ⊆ A; S = A \\ H, per §4).
    """

    values: Mapping[str, float]
    hard: frozenset = DEFAULT_HARD

    def __post_init__(self):
        object.__setattr__(self, "values", dict(self.values))
        missing = self.hard - set(self.values)
        if missing:
            raise ValueError(f"hard dims {sorted(missing)} not in vector dims")

    # -- set views (paper §4: A = S ∪ H) ------------------------------------
    @property
    def dims(self) -> frozenset:
        return frozenset(self.values)

    @property
    def soft_dims(self) -> frozenset:
        return self.dims - self.hard

    def __getitem__(self, dim: str) -> float:
        return self.values.get(dim, 0.0)

    # -- arithmetic ----------------------------------------------------------
    def _merge(self, other: "ResourceVector", op) -> "ResourceVector":
        # Sorted so the result dict's key order (and any downstream
        # serialization/iteration) is independent of PYTHONHASHSEED.
        dims = sorted(set(self.values) | set(other.values))
        return ResourceVector(
            {d: op(self[d], other[d]) for d in dims}, self.hard | other.hard
        )

    def __add__(self, other: "ResourceVector") -> "ResourceVector":
        return self._merge(other, lambda a, b: a + b)

    def __sub__(self, other: "ResourceVector") -> "ResourceVector":
        return self._merge(other, lambda a, b: a - b)

    def scale(self, k: float) -> "ResourceVector":
        return ResourceVector({d: v * k for d, v in self.values.items()}, self.hard)

    # -- constraint checks ---------------------------------------------------
    def satisfies_hard(self, demand: "ResourceVector") -> bool:
        """Alg 4's feasibility filter: availability must cover every hard dim.

        The paper writes ``H_θ > H_τ``; equality-or-better is accepted here
        (a node with exactly enough memory is feasible).
        """
        return all(self[d] >= demand[d] for d in demand.hard)

    def satisfies_all(self, demand: "ResourceVector") -> bool:
        return all(self[d] >= demand[d] for d in demand.dims)

    def overload(self, demand: "ResourceVector") -> Dict[str, float]:
        """Per-dim amount by which ``demand`` exceeds availability (soft viol.)."""
        out = {}
        for d in sorted(demand.dims):
            excess = demand[d] - self[d]
            if excess > 0:
                out[d] = excess
        return out

    def total(self, dims: Iterable[str] | None = None) -> float:
        dims = sorted(self.dims) if dims is None else dims
        return sum(self[d] for d in dims)

    def is_nonnegative(self) -> bool:
        return all(v >= -1e-9 for v in self.values.values())


def weighted_distance(
    demand: ResourceVector,
    avail: ResourceVector,
    *,
    weights: Mapping[str, float] | None = None,
    network_distance: float = 0.0,
) -> float:
    """Alg 4 DISTANCE: weighted Euclidean distance in resource space.

    ``distance = sqrt(w_m (m_τ−m_θ)² + w_c (c_τ−c_θ)² + w_b netDist(ref,θ)²)``

    The bandwidth dimension of a *node* is defined by the paper as the network
    distance from the Ref Node (§4.2), passed in as ``network_distance``;
    any explicit bandwidth demand/availability dims are ignored in favour of
    it, exactly as Alg 4 line 13 does.
    """
    w = dict(DEFAULT_WEIGHTS)
    if weights:
        w.update(weights)
    acc = 0.0
    # Sorted accumulation order: float addition is not associative, so the
    # hash-seeded set order would make the low bits run-dependent (and
    # disagree with the arena path, which reduces over sorted dims).
    for d in sorted((demand.dims | avail.dims) - {BANDWIDTH}):
        acc += w.get(d, 1.0) * (demand[d] - avail[d]) ** 2
    acc += w.get(BANDWIDTH, 1.0) * network_distance**2
    return math.sqrt(acc)


def demand(memory_mb: float = 0.0, cpu: float = 0.0, bw: float = 0.0) -> ResourceVector:
    """Convenience constructor for the paper's 3-D task demand A_τ."""
    return ResourceVector({MEMORY: memory_mb, CPU: cpu, BANDWIDTH: bw})
