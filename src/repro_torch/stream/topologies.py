"""The paper's evaluation topologies.

Micro-benchmarks (Fig 7): Linear, Diamond, Star — each in a *network-bound*
variant ("very little processing at each component", §6.3.1) and a
*computation-time-bound* variant ("significant amount of arbitrary
processing", §6.3.2).

Production topologies (Fig 11, "Modeled After Typical Industry Topologies"):
Yahoo PageLoad and Processing — event-level advertising pipelines for
near-real-time analytical reporting (§6.4); unanchored (at-most-once) as is
typical for high-volume analytics, so they push at source speed and shed load
at saturated tasks.

Resource demands follow the paper's user API (setMemoryLoad / setCPULoad);
per-tuple costs, tuple sizes and source ceilings parameterize the simulator.
"""

from __future__ import annotations

from ..core.topology import Topology
from .api import TopologyBuilder

# -- micro-benchmarks (Fig 7) --------------------------------------------------

# Network-bound settings (§6.3.1: "very little processing at each component"):
# negligible per-tuple CPU, mid-size tuples, and a finite ack window so the
# placement-dependent credit-loop latency is what limits throughput.
_NET = dict(cpu_cost_per_tuple=2e-4, tuple_bytes=128.0)
_NET_PENDING = 64

# CPU-bound settings (§6.3.2): sources have an intrinsic per-task emit ceiling
# (the reason adding machines stops helping) and bolts do real work per tuple.
_CPU_PENDING = 4096
_CPU_SOURCE_RATE = 500.0  # tuples/s per spout task


def linear(network_bound: bool = True, parallelism: int = 4) -> Topology:
    """Fig 7a: spout -> b1 -> b2 -> b3."""
    kind = "net" if network_bound else "cpu"
    b = TopologyBuilder(f"linear_{kind}")
    b.set_max_spout_pending(_NET_PENDING if network_bound else _CPU_PENDING)
    if network_bound:
        b.set_spout("spout", parallelism=parallelism, **_NET).set_memory_load(
            512.0
        ).set_cpu_load(10.0)
        prev = "spout"
        for i in range(1, 4):
            cid = f"bolt{i}"
            comp = b.set_bolt(cid, parallelism=parallelism, inputs=[prev], **_NET)
            comp.set_memory_load(512.0).set_cpu_load(10.0)
            prev = cid
    else:
        b.set_spout(
            "spout",
            parallelism=parallelism,
            cpu_cost_per_tuple=0.01,
            tuple_bytes=64.0,
            max_rate_per_task=_CPU_SOURCE_RATE,
        ).set_memory_load(640.0).set_cpu_load(10.0)
        prev = "spout"
        for i in range(1, 4):
            cid = f"bolt{i}"
            comp = b.set_bolt(
                cid,
                parallelism=parallelism,
                inputs=[prev],
                cpu_cost_per_tuple=0.04,
                tuple_bytes=64.0,
            )
            comp.set_memory_load(640.0).set_cpu_load(25.0)
            prev = cid
    return b.create_topology()


def diamond(network_bound: bool = True, parallelism: int = 4) -> Topology:
    """Fig 7b: spout fans out to mid1..mid3, which join into one sink bolt."""
    kind = "net" if network_bound else "cpu"
    b = TopologyBuilder(f"diamond_{kind}")
    b.set_max_spout_pending(_NET_PENDING if network_bound else _CPU_PENDING)
    if network_bound:
        b.set_spout("spout", parallelism=parallelism, **_NET).set_memory_load(
            400.0
        ).set_cpu_load(10.0)
        mids = []
        for i in range(1, 4):
            cid = f"mid{i}"
            b.set_bolt(cid, parallelism=parallelism, inputs=["spout"], **_NET).set_memory_load(
                400.0
            ).set_cpu_load(10.0)
            mids.append(cid)
        b.set_bolt("sink", parallelism=parallelism, inputs=mids, **_NET).set_memory_load(
            400.0
        ).set_cpu_load(10.0)
    else:
        b.set_spout(
            "spout",
            parallelism=parallelism,
            cpu_cost_per_tuple=0.01,
            tuple_bytes=64.0,
            max_rate_per_task=_CPU_SOURCE_RATE,
        ).set_memory_load(600.0).set_cpu_load(10.0)
        mids = []
        for i in range(1, 4):
            cid = f"mid{i}"
            b.set_bolt(
                cid,
                parallelism=parallelism,
                inputs=["spout"],
                cpu_cost_per_tuple=0.03,
                tuple_bytes=64.0,
            ).set_memory_load(600.0).set_cpu_load(18.0)
            mids.append(cid)
        b.set_bolt(
            "sink",
            parallelism=parallelism,
            inputs=mids,
            cpu_cost_per_tuple=0.012,
            tuple_bytes=64.0,
        ).set_memory_load(600.0).set_cpu_load(22.0)
    return b.create_topology()


def star(network_bound: bool = True, parallelism: int = 4) -> Topology:
    """Fig 7c: two spouts feed a central bolt which fans out to two sinks.

    The centre is deliberately heavy — §6.3.2 observes default Storm
    over-utilizes one machine here ("creates a bottleneck that throttles the
    overall throughput of the Star topology").
    """
    kind = "net" if network_bound else "cpu"
    b = TopologyBuilder(f"star_{kind}")
    b.set_max_spout_pending(_NET_PENDING if network_bound else _CPU_PENDING)
    if network_bound:
        net = dict(_NET, tuple_bytes=64.0)  # fan-in/out doubles flows; keep NICs off the floor
        for i in (1, 2):
            b.set_spout(f"spout{i}", parallelism=parallelism, **net).set_memory_load(
                384.0
            ).set_cpu_load(10.0)
        b.set_bolt(
            "centre", parallelism=parallelism, inputs=["spout1", "spout2"], **net
        ).set_memory_load(512.0).set_cpu_load(15.0)
        for i in (1, 2):
            b.set_bolt(
                f"out{i}", parallelism=parallelism, inputs=["centre"], **net
            ).set_memory_load(384.0).set_cpu_load(10.0)
    else:
        # More tasks than machines: default Storm inevitably stacks two heavy
        # centre tasks on one node — the paper's bottleneck machine (§6.3.2).
        parallelism = max(parallelism, 6)
        for i in (1, 2):
            b.set_spout(
                f"spout{i}",
                parallelism=parallelism,
                cpu_cost_per_tuple=0.01,
                tuple_bytes=64.0,
                max_rate_per_task=_CPU_SOURCE_RATE,
            ).set_memory_load(400.0).set_cpu_load(6.0)
        # Heavy centre: each task needs most of a core at the source rate.
        b.set_bolt(
            "centre",
            parallelism=parallelism,
            inputs=["spout1", "spout2"],
            cpu_cost_per_tuple=0.085,
            tuple_bytes=64.0,
        ).set_memory_load(500.0).set_cpu_load(85.0)
        for i in (1, 2):
            b.set_bolt(
                f"out{i}",
                parallelism=parallelism,
                inputs=["centre"],
                cpu_cost_per_tuple=0.005,
                tuple_bytes=64.0,
            ).set_memory_load(400.0).set_cpu_load(6.0)
    return b.create_topology()


# -- Yahoo production topologies (Fig 11) ---------------------------------------


def pageload(parallelism: int = 3) -> Topology:
    """Fig 11a — PageLoad: event-level page-load records from the ad platform,
    deserialized, filtered, geo/session-enriched, aggregated, persisted.
    Unanchored analytics pipeline: big tuples make it placement/bandwidth
    sensitive."""
    b = TopologyBuilder("pageload")
    b.set_max_spout_pending(10)
    t = b.set_spout(
        "kafka_spout",
        parallelism=parallelism,
        cpu_cost_per_tuple=0.004,
        tuple_bytes=6000.0,
        max_rate_per_task=1600.0,
    )
    t.set_memory_load(400.0).set_cpu_load(20.0)
    chain = [
        # (id, emit_ratio, cpu_cost, tuple_bytes, mem, cpu_load)
        ("deserialize", 1.0, 0.010, 5500.0, 400.0, 25.0),
        ("filter", 0.7, 0.006, 5500.0, 300.0, 15.0),
        ("geo_enrich", 1.0, 0.015, 6500.0, 500.0, 30.0),
        ("session_join", 1.0, 0.020, 6500.0, 500.0, 35.0),
        ("aggregate", 0.4, 0.012, 2500.0, 400.0, 25.0),
        ("persist", 1.0, 0.008, 2500.0, 300.0, 15.0),
    ]
    prev = "kafka_spout"
    for cid, ratio, cost, nbytes, mem, load in chain:
        comp = b.set_bolt(
            cid,
            parallelism=parallelism,
            inputs=[prev],
            emit_ratio=ratio,
            cpu_cost_per_tuple=cost,
            tuple_bytes=nbytes,
            grouping="local_or_shuffle",
        )
        comp.set_memory_load(mem).set_cpu_load(load)
        prev = cid
    return b.create_topology()  # acked: near-real-time reporting pipeline


def processing(parallelism: int = 2) -> Topology:
    """Fig 11b — Processing: heavier event-processing pipeline (rules engine +
    dedupe over large in-memory state + rollup), memory-hungry by design —
    two of its tasks on one 2 GB node over-subscribe memory."""
    b = TopologyBuilder("processing")
    b.set_spout(
        "event_spout",
        parallelism=parallelism,
        cpu_cost_per_tuple=0.005,
        tuple_bytes=10000.0,
        max_rate_per_task=1800.0,
    ).set_memory_load(800.0).set_cpu_load(20.0)
    b.set_bolt(
        "parse",
        parallelism=parallelism,
        inputs=["event_spout"],
        cpu_cost_per_tuple=0.012,
        tuple_bytes=4000.0,
        grouping="local_or_shuffle",
    ).set_memory_load(1050.0).set_cpu_load(30.0)
    b.set_bolt(
        "rules_engine",
        parallelism=parallelism,
        inputs=["parse"],
        cpu_cost_per_tuple=0.030,
        tuple_bytes=3800.0,
        grouping="local_or_shuffle",
    ).set_memory_load(1300.0).set_cpu_load(45.0)
    b.set_bolt(
        "dedupe",
        parallelism=parallelism,
        inputs=["rules_engine"],
        cpu_cost_per_tuple=0.015,
        tuple_bytes=3800.0,
        emit_ratio=0.8,
        grouping="local_or_shuffle",
    ).set_memory_load(1300.0).set_cpu_load(35.0)
    b.set_bolt(
        "rollup",
        parallelism=parallelism,
        inputs=["dedupe"],
        cpu_cost_per_tuple=0.012,
        tuple_bytes=1500.0,
        emit_ratio=0.5,
        grouping="local_or_shuffle",
    ).set_memory_load(1050.0).set_cpu_load(25.0)
    b.set_bolt(
        "db_writer",
        parallelism=parallelism,
        inputs=["rollup"],
        cpu_cost_per_tuple=0.008,
        tuple_bytes=1500.0,
        grouping="local_or_shuffle",
    ).set_memory_load(800.0).set_cpu_load(15.0)
    topo = b.create_topology()
    topo.acked = False
    return topo


ALL_MICRO = {
    "linear": linear,
    "diamond": diamond,
    "star": star,
}

ALL_YAHOO = {
    "pageload": pageload,
    "processing": processing,
}

ALL = {**ALL_MICRO, **ALL_YAHOO}


def make(name: str, **kwargs) -> Topology:
    """Build a named evaluation topology (scenario-table style)."""
    if name not in ALL:
        raise KeyError(f"unknown topology {name!r}; have {sorted(ALL)}")
    return ALL[name](**kwargs)
