"""Algorithm 4 — node selection by weighted Euclidean distance in resource
space, anchored on the Ref Node."""

from __future__ import annotations

import math
from typing import AbstractSet, Dict, Mapping, Optional, Tuple

from .cluster import Cluster, Node
from .resources import BANDWIDTH, CPU, MEMORY, ResourceVector, weighted_distance

#: Colocate-with-upstream distance discount (DESIGN.md §6.1b) — the default
#: ``credit`` for both selection twins (NodeSelector and ArenaSelector).
PEER_CREDIT = 0.75

DEFAULT_SOFT_WEIGHTS: Mapping[str, float] = {
    # Normalizing weights: memory is in MB (thousands), CPU in points
    # (hundreds) — the paper allows weights "so that values can be normalized
    # for comparison".  These bring each term to O(1) for the Emulab node
    # (2048 MB, 100 points) and make one rack hop cost about as much as a
    # fully-loaded node, which reproduces the paper's pack-then-spill order.
    MEMORY: (1.0 / 2048.0) ** 2,
    CPU: (1.0 / 50.0) ** 2,
    BANDWIDTH: 1.0,
}


class NodeSelector:
    """Stateful node selection: holds the Ref Node across calls (Alg 4's
    ``global refNode``)."""

    def __init__(
        self,
        cluster: Cluster,
        weights: Optional[Mapping[str, float]] = None,
    ):
        self.cluster = cluster
        self.weights = dict(DEFAULT_SOFT_WEIGHTS)
        if weights:
            self.weights.update(weights)
        self.ref_node: Optional[str] = None

    # -- Alg 4 lines 6-9 -------------------------------------------------------
    def _establish_ref_node(self) -> str:
        rack = self.cluster.rack_with_most_resources()
        node = self.cluster.node_with_most_resources(rack)
        self.ref_node = node.id
        return node.id

    def distance(self, task_demand: ResourceVector, node: Node) -> float:
        """Alg 4 DISTANCE procedure."""
        ref = self.ref_node if self.ref_node is not None else node.id
        net = self.cluster.network_distance(ref, node.id)
        return weighted_distance(
            task_demand, node.available, weights=self.weights, network_distance=net
        )

    def select(
        self,
        task_demand: ResourceVector,
        credit_nodes: Optional[AbstractSet[str]] = None,
        credit: float = PEER_CREDIT,
    ) -> Optional[Node]:
        """Pick argmin-distance feasible node; None if no node satisfies the
        hard constraints (scheduler reports the task unassigned — R-Storm
        never violates hard constraints, property 2 in §4.1).

        ``credit_nodes`` (first-class peer-credit option, DESIGN.md §6.1b):
        candidates in the set get their distance multiplied by ``credit``, so
        among near-equidistant nodes the one already hosting an upstream peer
        wins — the quadratic-term colocation credit R-Storm+ uses.
        """
        if self.ref_node is None or not self.cluster.nodes[self.ref_node].alive:
            self._establish_ref_node()
        best: Optional[Node] = None
        best_d = math.inf
        # Deterministic iteration order for reproducible schedules.
        for nid in sorted(self.cluster.nodes):
            node = self.cluster.nodes[nid]
            if not node.alive or not node.can_fit_hard(task_demand):
                continue
            d = self.distance(task_demand, node)
            if credit_nodes and nid in credit_nodes:
                d *= credit
            if d < best_d - 1e-12:
                best, best_d = node, d
        return best
