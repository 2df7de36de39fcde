"""Cluster model: racks of worker nodes with resource budgets (paper §3, §4).

Mirrors the paper's Emulab environment (§6.1): racks connected by a
top-of-rack switch, nodes with CPU-point / memory-MB budgets, and the
network-distance hierarchy the scheduling insight is built on:

    intra-process < inter-process < inter-node (intra-rack) < inter-rack
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from .resources import BANDWIDTH, CPU, MEMORY, ResourceVector, demand

# Network-distance constants (dimensionless hop weights used by Alg 4's
# distance term; latency seconds used by the simulator live on NetworkModel).
D_INTRA_PROCESS = 0.0
D_INTER_PROCESS = 0.5
D_INTER_NODE = 1.0
D_INTER_RACK = 2.0


@dataclasses.dataclass
class NodeSpec:
    """Static description of one worker node (paper §5.2 storm.yaml)."""

    node_id: str
    rack_id: str
    cpu_capacity: float = 100.0       # supervisor.cpu.capacity (points)
    memory_capacity_mb: float = 2048.0  # supervisor.memory.capacity.mb
    bandwidth_capacity: float = 100.0   # NIC, arbitrary units (Mbps in paper)
    num_worker_slots: int = 4


class Node:
    """A worker node with mutable remaining availability A_θ."""

    def __init__(self, spec: NodeSpec):
        self.spec = spec
        self.available = demand(
            spec.memory_capacity_mb, spec.cpu_capacity, spec.bandwidth_capacity
        )
        self.assigned_tasks: List = []
        self.alive = True

    @property
    def id(self) -> str:  # noqa: A003
        return self.spec.node_id

    @property
    def rack_id(self) -> str:
        return self.spec.rack_id

    @property
    def capacity(self) -> ResourceVector:
        return demand(
            self.spec.memory_capacity_mb,
            self.spec.cpu_capacity,
            self.spec.bandwidth_capacity,
        )

    def can_fit_hard(self, task_demand: ResourceVector) -> bool:
        return self.available.satisfies_hard(task_demand)

    def assign(self, task, task_demand: ResourceVector) -> None:
        self.assigned_tasks.append(task)
        self.available = self.available - task_demand

    def unassign(self, task, task_demand: ResourceVector) -> None:
        self.assigned_tasks.remove(task)
        self.available = self.available + task_demand

    def used(self) -> ResourceVector:
        return self.capacity - self.available

    def __repr__(self) -> str:
        return f"Node({self.id}@{self.rack_id}, avail={dict(self.available.values)})"


class Cluster:
    """A set of racks, each holding worker nodes."""

    def __init__(self, nodes: Iterable[NodeSpec]):
        self.nodes: Dict[str, Node] = {}
        self.racks: Dict[str, List[str]] = {}
        for spec in nodes:
            if spec.node_id in self.nodes:
                raise ValueError(f"duplicate node id {spec.node_id!r}")
            self.nodes[spec.node_id] = Node(spec)
            self.racks.setdefault(spec.rack_id, []).append(spec.node_id)
        if not self.nodes:
            raise ValueError("cluster must have at least one node")

    # -- construction helpers -------------------------------------------------
    @classmethod
    def homogeneous(
        cls,
        *,
        racks: int,
        nodes_per_rack: int,
        cpu: float = 100.0,
        memory_mb: float = 2048.0,
        bandwidth: float = 100.0,
        slots: int = 4,
    ) -> "Cluster":
        """The paper's Emulab layout: e.g. racks=2, nodes_per_rack=6."""
        specs = [
            NodeSpec(
                node_id=f"r{r}n{n}",
                rack_id=f"rack{r}",
                cpu_capacity=cpu,
                memory_capacity_mb=memory_mb,
                bandwidth_capacity=bandwidth,
                num_worker_slots=slots,
            )
            for r in range(racks)
            for n in range(nodes_per_rack)
        ]
        return cls(specs)

    # -- queries ---------------------------------------------------------------
    def live_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.alive]

    def network_distance(self, a: str, b: str) -> float:
        """Hop-weight distance between two nodes (Alg 4's netDist term)."""
        if a == b:
            return D_INTER_PROCESS  # same node, different worker process
        na, nb = self.nodes[a], self.nodes[b]
        if na.rack_id == nb.rack_id:
            return D_INTER_NODE
        return D_INTER_RACK

    def rack_available(self, rack_id: str) -> ResourceVector:
        acc = demand()
        for nid in self.racks[rack_id]:
            node = self.nodes[nid]
            if node.alive:
                acc = acc + node.available
        return acc

    def rack_with_most_resources(self) -> str:
        """Alg 4 line 7 — rack with max total availability.

        'Most resources' is the sum over soft+hard dims of availability,
        normalized per-dim by cluster-wide capacity so that no single unit
        (MB vs points) dominates.
        """
        totals: Dict[str, float] = {}
        cap = self.total_capacity()
        for rid in self.racks:
            avail = self.rack_available(rid)
            # Sorted dims: the accumulation order of this float sum feeds
            # Ref-Node choice, so it must not depend on PYTHONHASHSEED.
            totals[rid] = sum(
                avail[d] / cap[d] for d in sorted(avail.dims) if cap[d] > 0
            )
        # Deterministic tie-break by rack id.
        return max(sorted(totals), key=lambda r: totals[r])

    def node_with_most_resources(self, rack_id: str) -> Node:
        """Alg 4 line 8 — node in the rack with max availability."""
        cap = self.total_capacity()

        def score(nid: str) -> float:
            avail = self.nodes[nid].available
            return sum(
                avail[d] / cap[d] for d in sorted(avail.dims) if cap[d] > 0
            )

        live = [nid for nid in self.racks[rack_id] if self.nodes[nid].alive]
        if not live:
            raise RuntimeError(f"no live nodes in rack {rack_id}")
        best = max(sorted(live), key=score)
        return self.nodes[best]

    def total_capacity(self) -> ResourceVector:
        acc = demand()
        for node in self.nodes.values():
            acc = acc + node.capacity
        return acc

    def total_available(self) -> ResourceVector:
        acc = demand()
        for node in self.live_nodes():
            acc = acc + node.available
        return acc

    # -- failure injection (fault-tolerance path) ------------------------------
    def fail_node(self, node_id: str) -> List:
        """Mark a node dead; return the tasks that were running on it."""
        node = self.nodes[node_id]
        node.alive = False
        orphans = list(node.assigned_tasks)
        node.assigned_tasks.clear()
        node.available = node.capacity  # resources are gone with the node
        return orphans

    def restore_node(self, node_id: str) -> None:
        node = self.nodes[node_id]
        node.alive = True
        node.available = node.capacity
        node.assigned_tasks.clear()

    def reset(self) -> None:
        for node in self.nodes.values():
            node.available = node.capacity
            node.assigned_tasks.clear()
            node.alive = True

    def __repr__(self) -> str:
        return f"Cluster({len(self.racks)} racks, {len(self.nodes)} nodes)"


def emulab_cluster() -> Cluster:
    """The paper's §6.1 experimental cluster: 12 workers in 2 racks,
    1 core (100 points) and 2 GB per node, 100 Mbps NICs."""
    return Cluster.homogeneous(racks=2, nodes_per_rack=6)


def emulab_cluster_24() -> Cluster:
    """The paper's §6.5 multi-topology cluster: 24 machines in two 12-node
    sub-clusters."""
    return Cluster.homogeneous(racks=2, nodes_per_rack=12)
