"""Schedulers: R-Storm (Alg 1) on the array-backed placement engine.

Every scheduler is a pure function of (topology, cluster-state): it never
mutates the cluster it is given unless ``commit=True`` — matching Nimbus
statelessness (paper §5) and enabling deterministic elastic re-planning.

This slice carries ``Scheduler`` and the arena path of ``RStormScheduler``;
the legacy dict engine, round-robin, R-Storm+ and the annealed scheduler
come with a later slice of the port.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional

from .assignment import Assignment
from .cluster import Cluster
from .engine import ArenaSelector, PlacementArena
from .registry import KwargField, register_scheduler
from .topology import Topology
from .traversal import task_selection

# Shared kwarg schemas.
_WEIGHTS = KwargField(
    types=(dict, type(None)),
    default=None,
    doc="soft-dimension distance weights (Alg 4), e.g. {'cpu_points': 4e-4}",
)


class Scheduler:
    """Interface mirroring Storm's IScheduler (paper §5)."""

    name = "base"

    def schedule(self, topology: Topology, cluster: Cluster, *, commit: bool = True) -> Assignment:
        raise NotImplementedError

    # Shared plumbing ----------------------------------------------------------
    def _finish(
        self,
        topology: Topology,
        cluster: Cluster,
        assignment: Assignment,
        commit: bool,
        t0: float,
    ) -> Assignment:
        assignment.scheduler_name = self.name
        assignment.schedule_time_s = time.perf_counter() - t0
        if commit:
            # Atomic apply onto the real cluster (paper §4.1).
            assignment.apply(topology, cluster)
        return assignment


@register_scheduler("rstorm", kwargs_schema={"weights": _WEIGHTS})
class RStormScheduler(Scheduler):
    """Algorithm 1: taskOrdering = TaskSelection(); for each task, NodeSelection."""

    def __init__(self, weights: Optional[Mapping[str, float]] = None):
        self.weights = weights

    def schedule(self, topology: Topology, cluster: Cluster, *, commit: bool = True) -> Assignment:
        t0 = time.perf_counter()
        topology.validate()
        assignment = Assignment(topology_id=topology.id)
        # Arena path: compile once, then one vectorized reduction per task.
        # The arena's availability ledger is the scratch state — the real
        # cluster is never touched until commit.
        arena = PlacementArena(cluster, topology, self.weights)
        self._place_on_arena(arena, topology, assignment)
        return self._finish(topology, cluster, assignment, commit, t0)

    def _place_on_arena(
        self,
        arena: PlacementArena,
        topology: Topology,
        assignment: Assignment,
        order=None,
    ) -> None:
        """The arena placement loop (re-run by the search subsystem under
        randomized task orders via ``order``; default is Alg 3's task
        selection)."""
        selector = ArenaSelector(arena)
        rows: Dict[str, tuple] = {}
        for task in task_selection(topology) if order is None else order:
            cid = task.component_id
            if cid not in rows:
                rows[cid] = arena.compile_demand(
                    topology.components[cid].resource_demand
                )
            row, hard = rows[cid]
            i = selector.select(row, hard)
            if i is None:
                assignment.unassigned.append(task.id)
                continue
            arena.assign(i, row)
            assignment.placements[task.id] = arena.node_ids[i]
