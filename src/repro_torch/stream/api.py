"""Storm-style TopologyBuilder user API (paper §5.2).

Mirrors the Java API surface::

    builder = TopologyBuilder("word_count")
    s1 = builder.set_spout("word", parallelism=10)
    s1.set_memory_load(1024.0)
    s1.set_cpu_load(50.0)
    b1 = builder.set_bolt("count", parallelism=4, inputs=["word"])
    topo = builder.create_topology()
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from ..core.topology import Component, Topology


class TopologyBuilder:
    def __init__(self, topology_id: str):
        self._topology = Topology(topology_id)

    def set_spout(
        self,
        cid: str,
        fn: Optional[Callable] = None,
        parallelism: int = 1,
        *,
        emit_ratio: float = 1.0,
        tuple_bytes: float = 100.0,
        cpu_cost_per_tuple: Optional[float] = None,
        max_rate_per_task: Optional[float] = None,
    ) -> Component:
        comp = Component(
            cid,
            is_spout=True,
            parallelism=parallelism,
            fn=fn,
            emit_ratio=emit_ratio,
            tuple_bytes=tuple_bytes,
            cpu_cost_per_tuple=cpu_cost_per_tuple,
            max_rate_per_task=max_rate_per_task,
        )
        return self._topology.add_component(comp)

    def set_bolt(
        self,
        cid: str,
        fn: Optional[Callable] = None,
        parallelism: int = 1,
        *,
        inputs: Sequence[str] = (),
        emit_ratio: float = 1.0,
        tuple_bytes: float = 100.0,
        cpu_cost_per_tuple: Optional[float] = None,
        max_rate_per_task: Optional[float] = None,
        grouping: str = "shuffle",
    ) -> Component:
        comp = Component(
            cid,
            is_spout=False,
            parallelism=parallelism,
            fn=fn,
            emit_ratio=emit_ratio,
            tuple_bytes=tuple_bytes,
            cpu_cost_per_tuple=cpu_cost_per_tuple,
            max_rate_per_task=max_rate_per_task,
        )
        self._topology.add_component(comp)
        for src in inputs:
            self._topology.add_edge(src, cid, grouping=grouping)
        return comp

    def set_max_spout_pending(self, pending: int) -> "TopologyBuilder":
        self._topology.max_spout_pending = int(pending)
        return self

    def create_topology(self) -> Topology:
        self._topology.validate()
        return self._topology
