"""PlacementArena — the array-backed substrate under every scheduler.

A ``(Topology, Cluster)`` pair is compiled into dense numpy arrays once per
``schedule()`` call:

* an N×D node-availability matrix (D = union of resource dims),
* an N×N network-distance matrix precomputed from the rack topology,
* per-component demand rows and hard-constraint column masks,
* an alive mask.

On these, Alg 4's argmin-distance node selection is one masked vectorized
reduction, hard-constraint filtering is a boolean mask, and "plan on a
scratch copy" is a cheap availability snapshot/rollback instead of
``copy.deepcopy(cluster)``.  The arena never mutates the cluster it was
compiled from — commit still happens at the ``Assignment.apply`` boundary.

Numerical contract: for the canonical three-dimensional resource vectors the
arena computes the exact same float64 operations in an order equivalent (by
commutativity) to the dict path, so placements are bit-identical to
``NodeSelector`` — the golden-equivalence suite pins this.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..cluster import (
    Cluster,
    D_INTER_NODE,
    D_INTER_PROCESS,
    D_INTER_RACK,
)
from ..node_selection import DEFAULT_SOFT_WEIGHTS, PEER_CREDIT
from ..resources import BANDWIDTH, ResourceVector
from ..topology import Topology

#: Same strict-improvement threshold as NodeSelector's sequential scan.
SELECT_EPS = 1e-12


def swap_network_delta(net, na, nb, pa, pb, m_ab=0, mask_a=None, mask_b=None, xp=np):
    """O(degree) network-cost delta for swapping the nodes of two tasks.

    The one incremental-delta implementation shared by the sequential
    ``SwapAnnealer`` (scalars: ``na``/``nb`` node indices, ``pa``/``pb`` the
    neighbours' node indices as ``(deg,)`` rows) and the batched search
    engine (``(B,)`` node indices, ``(B, max_deg)`` padded neighbour rows
    with ``mask_*`` flagging real entries, ``xp=jax.numpy`` inside jit).

    ``m_ab`` counts direct a-b edges: those terms cancel exactly in the true
    cost (``net`` is symmetric) but are double-counted by the two neighbour
    sums, so their spurious contribution is subtracted.
    """
    na_r = xp.asarray(na)[..., None]
    nb_r = xp.asarray(nb)[..., None]
    da = net[nb_r, pa] - net[na_r, pa]
    db = net[na_r, pb] - net[nb_r, pb]
    if mask_a is not None:
        da = xp.where(mask_a, da, 0.0)
    if mask_b is not None:
        db = xp.where(mask_b, db, 0.0)
    corr = net[na, na] + net[nb, nb] - 2.0 * net[na, nb]
    return da.sum(axis=-1) + db.sum(axis=-1) - m_ab * corr


def swap_overload_delta(cap_a, cap_b, used_a, used_b, dem_i, dem_j, xp=np):
    """Hard-dimension overload delta for the same swap, O(dims).

    Works on scalars (the annealer's single memory dimension) or on
    ``(B, Dh)`` per-chain rows (the batched search), summing the per-dim
    relu terms over the trailing axis.
    """
    ua2 = used_a - dem_i + dem_j
    ub2 = used_b - dem_j + dem_i
    d = (
        xp.maximum(0.0, ua2 - cap_a)
        - xp.maximum(0.0, used_a - cap_a)
        + xp.maximum(0.0, ub2 - cap_b)
        - xp.maximum(0.0, used_b - cap_b)
    )
    d = xp.asarray(d)
    return d.sum(axis=-1) if d.ndim else d


class PlacementArena:
    """Dense-array view of a cluster (plus optional topology demand dims)."""

    def __init__(
        self,
        cluster: Cluster,
        topology: Optional[Topology] = None,
        weights: Optional[Mapping[str, float]] = None,
    ):
        self.cluster = cluster
        # Node index <-> id, in sorted-id order (the dict path's iteration
        # order, so argmin tie-breaks agree).
        self.node_ids: List[str] = sorted(cluster.nodes)
        self.index: Dict[str, int] = {nid: i for i, nid in enumerate(self.node_ids)}
        n = len(self.node_ids)

        # Dimension columns: union of cluster availability dims and (when
        # given) topology demand dims, in sorted order.
        dims = set()
        for node in cluster.nodes.values():
            dims |= set(node.available.values)
        if topology is not None:
            for comp in topology.components.values():
                dims |= set(comp.resource_demand.values)
        self.dims: List[str] = sorted(dims)
        self.dim_col: Dict[str, int] = {d: j for j, d in enumerate(self.dims)}
        self._soft_cols = np.array(
            [j for j, d in enumerate(self.dims) if d != BANDWIDTH], dtype=np.intp
        )
        d = len(self.dims)

        self.avail = np.zeros((n, d), dtype=np.float64)
        self.capacity = np.zeros((n, d), dtype=np.float64)
        self.alive = np.zeros(n, dtype=bool)
        rack_ids = sorted(cluster.racks)
        rack_code = {rid: k for k, rid in enumerate(rack_ids)}
        self.rack_ids: List[str] = rack_ids
        self._rack_of = np.zeros(n, dtype=np.intp)
        for i, nid in enumerate(self.node_ids):
            node = cluster.nodes[nid]
            for dim, v in node.available.values.items():
                self.avail[i, self.dim_col[dim]] = v
            for dim, v in node.capacity.values.items():
                self.capacity[i, self.dim_col[dim]] = v
            self.alive[i] = node.alive
            self._rack_of[i] = rack_code[node.rack_id]

        # N×N network-distance matrix from the rack topology (Alg 4 netDist).
        same_rack = self._rack_of[:, None] == self._rack_of[None, :]
        self.net = np.where(same_rack, D_INTER_NODE, D_INTER_RACK)
        np.fill_diagonal(self.net, D_INTER_PROCESS)

        # Per-dim distance weights (NodeSelector/weighted_distance merge).
        merged = dict(DEFAULT_SOFT_WEIGHTS)
        if weights:
            merged.update(weights)
        self.weight_row = np.array(
            [merged.get(dim, 1.0) for dim in self.dims], dtype=np.float64
        )
        self._w_soft = self.weight_row[self._soft_cols]
        self._w_bw = merged.get(BANDWIDTH, 1.0)

    @property
    def rack_of(self) -> np.ndarray:
        """(N,) rack index per node (into ``rack_ids``) — the rack topology
        the batched search's link-flow proxy reduces over."""
        return self._rack_of

    # -- demand compilation ----------------------------------------------------
    def compile_demand(self, rv: ResourceVector) -> Tuple[np.ndarray, np.ndarray]:
        """(row over arena dims, hard-column index array) for one demand."""
        row = np.zeros(len(self.dims), dtype=np.float64)
        for dim, v in rv.values.items():
            row[self.dim_col[dim]] = v
        hard = np.array(sorted(self.dim_col[dim] for dim in rv.hard), dtype=np.intp)
        return row, hard

    # -- availability ledger ---------------------------------------------------
    def snapshot(self) -> np.ndarray:
        """Cheap copy of the availability ledger (replaces deepcopy)."""
        return self.avail.copy()

    def rollback(self, snap: np.ndarray) -> None:
        self.avail[...] = snap

    def assign(self, node_idx: int, demand_row: np.ndarray) -> None:
        self.avail[node_idx] -= demand_row

    def unassign(self, node_idx: int, demand_row: np.ndarray) -> None:
        self.avail[node_idx] += demand_row

    # -- Alg 4, vectorized -----------------------------------------------------
    def feasible_mask(self, demand_row: np.ndarray, hard_cols: np.ndarray) -> np.ndarray:
        """alive ∧ availability covers every hard dim (property 2, §4.1)."""
        if hard_cols.size == 0:
            return self.alive.copy()
        ok = (self.avail[:, hard_cols] >= demand_row[hard_cols]).all(axis=1)
        return self.alive & ok

    def distances(self, demand_row: np.ndarray, ref_idx: int) -> np.ndarray:
        """Alg 4 DISTANCE from every node, as one vectorized row.

        sqrt(Σ_soft w_d (demand_d − avail_d)² + w_bw netDist(ref, ·)²) —
        same float64 ops as ``weighted_distance`` per node.
        """
        diff = demand_row[self._soft_cols] - self.avail[:, self._soft_cols]
        acc = (self._w_soft * diff**2).sum(axis=1)
        acc += self._w_bw * self.net[ref_idx] ** 2
        return np.sqrt(acc)

    def select(
        self,
        demand_row: np.ndarray,
        hard_cols: np.ndarray,
        ref_idx: int,
        credit_mask: Optional[np.ndarray] = None,
        credit: Optional[float] = None,
    ) -> Optional[int]:
        """Argmin-distance feasible node index; None if none is feasible.

        Reproduces NodeSelector's sequential ``d < best − 1e-12`` scan: the
        winner is the first index attaining the minimum, except in the
        sub-epsilon band where the exact sequential scan is replayed.
        """
        feasible = self.feasible_mask(demand_row, hard_cols)
        if not feasible.any():
            return None
        d = self.distances(demand_row, ref_idx)
        if credit_mask is not None:
            d = np.where(credit_mask, d * (PEER_CREDIT if credit is None else credit), d)
        d = np.where(feasible, d, np.inf)
        m = d.min()
        near = d <= m + SELECT_EPS
        if (d[near] == m).all():
            # Clean case (ties are exact): sequential scan picks the first
            # index attaining the minimum.
            return int(np.argmin(d))
        # Sub-epsilon gaps: replay the dict path's scan exactly.
        best, best_d = None, np.inf
        for i in range(d.shape[0]):
            if d[i] < best_d - SELECT_EPS:
                best, best_d = i, d[i]
        return best

    # -- Alg 4 lines 6-9: Ref Node ---------------------------------------------
    def establish_ref_node(self) -> int:
        """Rack with most (capacity-normalized) resources, then node within it."""
        cap = self.capacity.sum(axis=0)
        safe_cap = np.where(cap > 0, cap, 1.0)
        live_avail = np.where(self.alive[:, None], self.avail, 0.0)
        n_racks = len(self.rack_ids)
        rack_tot = np.zeros((n_racks, len(self.dims)), dtype=np.float64)
        np.add.at(rack_tot, self._rack_of, live_avail)
        rack_scores = np.where(cap > 0, rack_tot / safe_cap, 0.0).sum(axis=1)
        best_rack = int(np.argmax(rack_scores))  # first max in sorted-rack order
        members = self._rack_of == best_rack
        node_scores = np.where(cap > 0, self.avail / safe_cap, 0.0).sum(axis=1)
        node_scores = np.where(members & self.alive, node_scores, -np.inf)
        if not np.isfinite(node_scores).any():
            raise RuntimeError(f"no live nodes in rack {self.rack_ids[best_rack]}")
        return int(np.argmax(node_scores))  # first max in sorted-id order

    # -- evaluation ------------------------------------------------------------
    def network_cost(
        self, placement: np.ndarray, edges: np.ndarray
    ) -> float:
        """Σ netDist over task-edge endpoint node indices (vectorized
        counterpart of ``Assignment.network_cost``; exact — all hop weights
        are multiples of 0.5)."""
        if edges.size == 0:
            return 0.0
        return float(self.net[placement[edges[:, 0]], placement[edges[:, 1]]].sum())
