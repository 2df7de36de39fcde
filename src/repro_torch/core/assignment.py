"""Schedule assignments: the output of any scheduler."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from .cluster import Cluster
from .topology import Task, Topology


@dataclasses.dataclass
class Assignment:
    """task.id -> node_id mapping plus bookkeeping for evaluation."""

    topology_id: str
    placements: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Tasks the scheduler could not place without violating a hard constraint.
    unassigned: List[str] = dataclasses.field(default_factory=list)
    scheduler_name: str = ""
    schedule_time_s: float = 0.0

    def node_of(self, task: Task) -> Optional[str]:
        return self.placements.get(task.id)

    def tasks_on(self, node_id: str) -> List[str]:
        return [t for t, n in self.placements.items() if n == node_id]

    def nodes_used(self) -> List[str]:
        return sorted(set(self.placements.values()))

    def is_complete(self, topology: Topology) -> bool:
        want = {t.id for t in topology.all_tasks()}
        return want == set(self.placements) and not self.unassigned

    def merge(self, other: "Assignment") -> "Assignment":
        merged = Assignment(
            topology_id=f"{self.topology_id}+{other.topology_id}",
            placements={**self.placements, **other.placements},
            unassigned=self.unassigned + other.unassigned,
            scheduler_name=self.scheduler_name,
            schedule_time_s=self.schedule_time_s + other.schedule_time_s,
        )
        return merged

    # -- evaluation helpers ----------------------------------------------------
    def network_cost(
        self, topology: Topology, cluster: Cluster, live_only: bool = False
    ) -> float:
        """Sum of netDist over all communicating task pairs (lower is better).

        This is the quadratic term of QM3DKP that R-Storm's greedy heuristic
        minimizes implicitly.  With ``live_only``, pairs touching a dead node
        are excluded — the cost of the traffic actually flowing, matching the
        simulator's placement-aware rates mid-failure.
        """
        cost = 0.0
        for src, dst in topology.task_edges():
            a, b = self.placements.get(src.id), self.placements.get(dst.id)
            if a is None or b is None:
                continue
            if live_only and not (cluster.nodes[a].alive and cluster.nodes[b].alive):
                continue
            cost += cluster.network_distance(a, b)
        return cost

    def hard_violations(self, topology: Topology, cluster: Cluster) -> List[str]:
        """Node ids whose hard (memory) budget the placement exceeds."""
        by_node: Dict[str, float] = {}
        demands = {t.id: topology.demand_of(t) for t in topology.all_tasks()}
        out = []
        for tid, nid in self.placements.items():
            if tid in demands:
                by_node[nid] = by_node.get(nid, 0.0) + demands[tid]["memory_mb"]
        for nid, used in by_node.items():
            if used > cluster.nodes[nid].spec.memory_capacity_mb + 1e-9:
                out.append(nid)
        return sorted(out)

    def apply(self, topology: Topology, cluster: Cluster) -> None:
        """Commit placements onto cluster state (atomic apply, paper §4.1:
        'actual assignment ... is done in an atomic fashion after the schedule
        mapping ... has been determined')."""
        tasks = {t.id: t for t in topology.all_tasks()}
        for tid, nid in self.placements.items():
            if tid in tasks:
                cluster.nodes[nid].assign(tasks[tid], topology.demand_of(tasks[tid]))
