"""Storm topology model: components (spouts/bolts), tasks, the DAG (paper §2).

A ``Component`` is a processing operator with a parallelism hint; each of its
``parallelism`` instances is a ``Task`` — the unit the scheduler places.  A
``Topology`` is the DAG of components.  Components carry per-instance resource
demands set via the Storm-style user API (paper §5.2:
``setMemoryLoad`` / ``setCPULoad``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .resources import BANDWIDTH, CPU, MEMORY, ResourceVector, demand


@dataclasses.dataclass(frozen=True)
class Task:
    """One instance of a component (paper: 'Tasks')."""

    component_id: str
    index: int
    topology_id: str = ""

    @property
    def id(self) -> str:  # noqa: A003
        prefix = f"{self.topology_id}/" if self.topology_id else ""
        return f"{prefix}{self.component_id}[{self.index}]"

    def __repr__(self) -> str:
        return f"Task({self.id})"


class Component:
    """A spout or bolt with a parallelism hint and per-instance demand."""

    def __init__(
        self,
        cid: str,
        *,
        is_spout: bool = False,
        parallelism: int = 1,
        fn: Optional[Callable] = None,
        emit_ratio: float = 1.0,
        tuple_bytes: float = 100.0,
        cpu_cost_per_tuple: Optional[float] = None,
        max_rate_per_task: Optional[float] = None,
    ):
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        self.id = cid
        self.is_spout = is_spout
        self.parallelism = parallelism
        self.fn = fn  # optional jitted/callable payload for the real executor
        # Performance-model attributes (simulator):
        self.emit_ratio = emit_ratio  # tuples emitted per tuple consumed
        self.tuple_bytes = tuple_bytes  # bytes per emitted tuple
        # Intrinsic per-task rate ceiling (tuples/s): a source's fetch/emit
        # loop or an I/O-bound sink cannot exceed this regardless of CPU.
        self.max_rate_per_task = max_rate_per_task
        # CPU-seconds of work per tuple, in core fractions; defaults to
        # cpu_load/100 points interpreted against a nominal per-tuple budget.
        self.cpu_cost_per_tuple = cpu_cost_per_tuple
        # User-API resource demands (paper §5.2); defaults mirror Storm's
        # (Storm defaults: 128 MB on-heap, 10 CPU points).
        self.memory_load: float = 128.0
        self.cpu_load: float = 10.0
        self.bandwidth_load: float = 0.0

    # -- Storm user API (paper §5.2) -----------------------------------------
    def set_memory_load(self, amount_mb: float) -> "Component":
        self.memory_load = float(amount_mb)
        return self

    def set_cpu_load(self, points: float) -> "Component":
        self.cpu_load = float(points)
        return self

    def set_bandwidth_load(self, amount: float) -> "Component":
        self.bandwidth_load = float(amount)
        return self

    @property
    def resource_demand(self) -> ResourceVector:
        """Per-task demand vector A_τ."""
        return demand(self.memory_load, self.cpu_load, self.bandwidth_load)

    def tasks(self, topology_id: str = "") -> List[Task]:
        return [Task(self.id, i, topology_id) for i in range(self.parallelism)]

    def __repr__(self) -> str:
        kind = "Spout" if self.is_spout else "Bolt"
        return f"{kind}({self.id} x{self.parallelism})"


class Topology:
    """A DAG of components with directed stream edges (paper Fig 1)."""

    def __init__(self, tid: str):
        self.id = tid
        self.components: Dict[str, Component] = {}
        self.edges: List[Tuple[str, str]] = []  # (src_component, dst_component)
        # (src, dst) -> "shuffle" | "local_or_shuffle" (Storm stream groupings)
        self.groupings: Dict[Tuple[str, str], str] = {}
        self.max_spout_pending: int = 1000  # Storm topology.max.spout.pending
        # Acked (anchored tuples, reliable) vs unanchored at-most-once mode.
        # Acked topologies are throttled by the max-spout-pending credit loop;
        # unanchored ones push as fast as sources allow and shed load at
        # saturated tasks (typical for high-volume analytics pipelines).
        self.acked: bool = True

    # -- construction ---------------------------------------------------------
    def add_component(self, comp: Component) -> Component:
        if comp.id in self.components:
            raise ValueError(f"duplicate component id {comp.id!r}")
        self.components[comp.id] = comp
        return comp

    def add_edge(self, src: str, dst: str, grouping: str = "shuffle") -> None:
        for cid in (src, dst):
            if cid not in self.components:
                raise KeyError(f"unknown component {cid!r}")
        if grouping not in ("shuffle", "local_or_shuffle"):
            raise ValueError(f"unknown grouping {grouping!r}")
        if (src, dst) in self.edges:
            return
        if src == dst:
            raise ValueError("self-loops are not valid stream groupings")
        self.edges.append((src, dst))
        self.groupings[(src, dst)] = grouping

    # -- views ----------------------------------------------------------------
    @property
    def spouts(self) -> List[Component]:
        return [c for c in self.components.values() if c.is_spout]

    @property
    def bolts(self) -> List[Component]:
        return [c for c in self.components.values() if not c.is_spout]

    def neighbors(self, cid: str) -> List[str]:
        """Downstream then upstream neighbours (BFS treats the DAG as a graph,
        so that e.g. a diamond's join bolt pulls its other parent close)."""
        down = [d for s, d in self.edges if s == cid]
        up = [s for s, d in self.edges if d == cid]
        return down + [u for u in up if u not in down]

    def downstream(self, cid: str) -> List[str]:
        return [d for s, d in self.edges if s == cid]

    def upstream(self, cid: str) -> List[str]:
        return [s for s, d in self.edges if d == cid]

    def sinks(self) -> List[Component]:
        """Components with no outgoing edges (throughput is measured here)."""
        srcs = {s for s, _ in self.edges}
        return [c for c in self.components.values() if c.id not in srcs]

    def all_tasks(self) -> List[Task]:
        out: List[Task] = []
        for comp in self.components.values():
            out.extend(comp.tasks(self.id))
        return out

    def task_count(self) -> int:
        return sum(c.parallelism for c in self.components.values())

    def component_of(self, task: Task) -> Component:
        return self.components[task.component_id]

    def demand_of(self, task: Task) -> ResourceVector:
        return self.components[task.component_id].resource_demand

    def task_edges(self) -> List[Tuple[Task, Task]]:
        """All-to-all task pairs along each component edge (shuffle grouping)."""
        out: List[Tuple[Task, Task]] = []
        for src, dst in self.edges:
            for ts in self.components[src].tasks(self.id):
                for td in self.components[dst].tasks(self.id):
                    out.append((ts, td))
        return out

    def total_demand(self) -> ResourceVector:
        acc = demand()
        for comp in self.components.values():
            acc = acc + comp.resource_demand.scale(comp.parallelism)
        return acc

    def validate(self) -> None:
        if not self.spouts:
            raise ValueError(f"topology {self.id!r} has no spout")
        # Reachability: every bolt reachable from some spout.
        seen = set(c.id for c in self.spouts)
        frontier = sorted(seen)
        while frontier:
            nxt = []
            for cid in frontier:
                for d in self.downstream(cid):
                    if d not in seen:
                        seen.add(d)
                        nxt.append(d)
            frontier = nxt
        unreachable = set(self.components) - seen
        if unreachable:
            raise ValueError(f"components unreachable from spouts: {sorted(unreachable)}")

    def __repr__(self) -> str:
        return (
            f"Topology({self.id}: {len(self.components)} components, "
            f"{self.task_count()} tasks, {len(self.edges)} edges)"
        )
