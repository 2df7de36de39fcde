"""Steady-state throughput simulator (the quantitative reproduction vehicle).

The paper (§6.3) classifies topology performance as bounded by either network
resources or computation time.  The simulator models one scheduled topology
(or several sharing the cluster, §6.5) with the mechanisms Storm actually
exhibits:

* **Source ceiling** — a spout task's fetch/emit loop has an intrinsic max
  rate; adding machines never raises it (§6.3.2: "a topology's throughput
  will reach a ceiling at which adding more machines will not improve
  performance").
* **CPU** — work-conserving processor sharing per node: the aggregate
  Σ rate×cost on a node cannot exceed its (effective) CPU points; the strict
  per-node bound is what an over-utilized machine imposes on every component
  with a task there (the paper's Star bottleneck).
* **Bandwidth** — per-NIC egress/ingress and per-rack uplink flows scale
  linearly with λ and cannot exceed link capacity.
* **Ack credit loop** (acked topologies) — Storm's max-spout-pending keeps
  ``pending`` tuples in flight, so λ = pending / L(λ), where L is the
  flow-weighted critical-path latency: placement-dependent hop latencies
  (intra-process < inter-process < inter-node < inter-rack, §4) + queueing-
  aware service delays + a constant acker round-trip.  This is what makes the
  paper's network-bound experiments placement-sensitive.
* **Load shedding** (unanchored topologies, ``topology.acked=False``) —
  saturated tasks drop their excess share; sink throughput is the saturating
  flow through the DAG.  Memory over-subscription (only the round-robin
  baseline produces it — R-Storm treats memory as a hard constraint) thrashes
  the node (effective CPU × ``thrash_factor``), so a topology whose tasks
  concentrate on thrashed nodes collapses (§6.5 Processing near-halt) while
  one with few tasks there merely degrades (PageLoad).

All rates are tuples/second; a topology's reported throughput is the sum of
tuple rates processed at its sink components (paper: "the average throughput
of all output bolts").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.assignment import Assignment
from ..core.cluster import Cluster
# One source of truth for "binding bound" semantics: the scalar simulator
# reduces its per-node usage/capacity dicts through the same array-form
# helper the batched throughput proxy vmaps over (core imports no stream
# module at import time, so this direction is cycle-free).
from ..core.search.throughput import capacity_bound
from ..core.topology import Component, Topology
from .network import EMULAB_NETWORK, NetworkModel

THRASH_FACTOR = 0.002  # effective CPU fraction for memory-thrashed nodes
NOMINAL_RATE = 1000.0  # tuples/s/task against which cpu_load is declared
ACK_OVERHEAD_S = 5e-3  # constant acker round-trip (spout→acker→spout)
TUPLE_TIMEOUT_S = 30.0  # Storm's topology.message.timeout.secs default
RHO_CAP = 0.999
_EPS = 1e-12


@dataclasses.dataclass
class SimResult:
    topology_id: str
    spout_rate: float                  # λ*, tuples/s per spout component
    sink_throughput: float             # Σ sink processed rates, tuples/s
    binding: str                       # "cpu" | "bandwidth" | "ack" | "source"
    latency_s: float                   # critical-path latency at λ*
    machines_used: int
    avg_cpu_utilization: float         # over machines hosting ≥1 task
    node_cpu_utilization: Dict[str, float]
    thrashed_nodes: List[str]
    bounds: Dict[str, float]           # each mechanism's standalone λ

    def throughput_per_10s(self) -> float:
        """Paper's y-axis unit (tuples/10sec)."""
        return self.sink_throughput * 10.0


def _cpu_cost(comp: Component) -> float:
    """CPU point-seconds per tuple processed by one task of ``comp``."""
    if comp.cpu_cost_per_tuple is not None:
        return comp.cpu_cost_per_tuple
    return comp.cpu_load / NOMINAL_RATE


def _topo_order(topology: Topology) -> List[str]:
    order: List[str] = []
    indeg = {cid: len(topology.upstream(cid)) for cid in topology.components}
    frontier = sorted(cid for cid, d in indeg.items() if d == 0)
    while frontier:
        cid = frontier.pop(0)
        order.append(cid)
        for dst in topology.downstream(cid):
            indeg[dst] -= 1
            if indeg[dst] == 0:
                frontier.append(dst)
    if len(order) != len(topology.components):
        raise ValueError(f"topology {topology.id!r} has a cycle; simulator requires a DAG")
    return order


def _component_rates(topology: Topology) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Per-unit-λ input/output rates per component (lossless propagation).

    Storm semantics: every subscriber receives the full stream of its source,
    so rate_in(c) = Σ_upstream rate_out(u);  rate_out = rate_in × emit_ratio.
    """
    rate_in: Dict[str, float] = {}
    rate_out: Dict[str, float] = {}
    for cid in _topo_order(topology):
        comp = topology.components[cid]
        if comp.is_spout:
            rate_in[cid] = 0.0
            rate_out[cid] = 1.0  # unit λ per spout component
        else:
            rin = sum(rate_out[u] for u in topology.upstream(cid))
            rate_in[cid] = rin
            rate_out[cid] = rin * comp.emit_ratio
    return rate_in, rate_out


class _TopologyLoad:
    """Per-unit-λ resource usage of one scheduled topology.

    Flows are tracked per *task*: shuffle grouping splits a task's output
    uniformly over all downstream tasks; local_or_shuffle routes it only to
    colocated downstream tasks when any exist (Storm's locality grouping —
    what makes R-Storm's colocation eliminate NIC traffic entirely on an
    edge).  Per-task input rates therefore differ within a component.
    """

    def __init__(self, topology: Topology, assignment: Assignment, cluster: Cluster):
        self.topology = topology
        self.assignment = assignment
        # Effective placements: a task whose node has died contributes no
        # load and no flow (mid-scenario, between a node failure and the
        # rebalance, its tuples simply aren't being processed).
        self.placements: Dict[str, str] = {
            tid: nid
            for tid, nid in assignment.placements.items()
            if cluster.nodes[nid].alive
        }
        self.rate_in, self.rate_out = _component_rates(topology)
        self.cpu: Dict[str, float] = {}       # node -> cpu points per unit λ
        self.egress: Dict[str, float] = {}    # node -> NIC bytes/s per unit λ
        self.ingress: Dict[str, float] = {}
        self.rack_up: Dict[str, float] = {}   # rack -> uplink bytes/s per unit λ
        self.memory: Dict[str, float] = {}    # node -> MB (static)
        # task.id -> per-unit-λ processed rate (spouts: emitted rate)
        self.task_rate: Dict[str, float] = {}
        # task.id -> [(dst_task_id, fraction_of_out)] routing table
        self.routes: Dict[str, List[Tuple[str, float]]] = {}
        # component edge -> list of (src_node, dst_node, flow_per_λ)
        self.edge_flows: Dict[Tuple[str, str], List[Tuple[str, str, float]]] = {}
        self._build(cluster)

    def _processed_per_task(self, cid: str) -> float:
        """Component-average per-task rate (used for source ceilings)."""
        comp = self.topology.components[cid]
        r = self.rate_out[cid] if comp.is_spout else self.rate_in[cid]
        return r / comp.parallelism

    def _build(self, cluster: Cluster) -> None:
        topo, asg = self.topology, self.assignment

        # Routing tables per edge (placement-dependent for local_or_shuffle).
        per_edge_routes: Dict[Tuple[str, str], Dict[str, List[str]]] = {}
        for src, dst in topo.edges:
            grouping = topo.groupings.get((src, dst), "shuffle")
            dst_tasks = [
                t for t in topo.components[dst].tasks(topo.id)
                if self.placements.get(t.id) is not None
            ]
            table: Dict[str, List[str]] = {}
            for ts in topo.components[src].tasks(topo.id):
                a = self.placements.get(ts.id)
                if a is None:
                    continue
                if grouping == "local_or_shuffle":
                    local = [t for t in dst_tasks if self.placements[t.id] == a]
                    table[ts.id] = [t.id for t in (local or dst_tasks)]
                else:
                    table[ts.id] = [t.id for t in dst_tasks]
            per_edge_routes[(src, dst)] = table

        # Per-task rate propagation in topological order.
        task_in: Dict[str, float] = {}
        for cid in _topo_order(topo):
            comp = topo.components[cid]
            for t in comp.tasks(topo.id):
                if self.placements.get(t.id) is None:
                    continue
                if comp.is_spout:
                    rate = 1.0 / comp.parallelism  # unit λ split across tasks
                else:
                    rate = task_in.get(t.id, 0.0)
                self.task_rate[t.id] = rate
                out = rate * comp.emit_ratio if not comp.is_spout else rate
                for dst in topo.downstream(cid):
                    targets = per_edge_routes[(cid, dst)].get(t.id, [])
                    if not targets:
                        continue
                    share = out / len(targets)
                    self.routes.setdefault(t.id, []).extend(
                        (tid, share) for tid in targets
                    )
                    for tid in targets:
                        task_in[tid] = task_in.get(tid, 0.0) + share

        # Node resource usage + edge flows.
        for task in topo.all_tasks():
            nid = self.placements.get(task.id)
            if nid is None:
                continue
            comp = topo.component_of(task)
            rate = self.task_rate.get(task.id, 0.0)
            self.cpu[nid] = self.cpu.get(nid, 0.0) + rate * _cpu_cost(comp)
            self.memory[nid] = self.memory.get(nid, 0.0) + comp.memory_load
        for (src, dst), table in per_edge_routes.items():
            csrc = topo.components[src]
            flows = []
            for ts_id, targets in table.items():
                a = self.placements[ts_id]
                comp = topo.components[src]
                out = self.task_rate.get(ts_id, 0.0) * (
                    1.0 if comp.is_spout else comp.emit_ratio
                )
                if not targets:
                    continue
                share = out / len(targets)
                for td_id in targets:
                    b = self.placements[td_id]
                    flows.append((a, b, share))
                    if a != b:
                        byt = share * csrc.tuple_bytes
                        self.egress[a] = self.egress.get(a, 0.0) + byt
                        self.ingress[b] = self.ingress.get(b, 0.0) + byt
                        ra, rb = cluster.nodes[a].rack_id, cluster.nodes[b].rack_id
                        if ra != rb:
                            self.rack_up[ra] = self.rack_up.get(ra, 0.0) + byt
            self.edge_flows[(src, dst)] = flows

    def nodes_used(self) -> List[str]:
        return sorted(set(self.placements.values()))

    def pending(self) -> float:
        return sum(
            self.topology.max_spout_pending * c.parallelism
            for c in self.topology.spouts
        )

    def source_bound(self) -> float:
        """λ ceiling from intrinsic per-task source rates."""
        b = math.inf
        for comp in self.topology.components.values():
            if comp.max_rate_per_task is None:
                continue
            for t in comp.tasks(self.topology.id):
                per_unit = self.task_rate.get(t.id, 0.0)
                if per_unit > _EPS:
                    b = min(b, comp.max_rate_per_task / per_unit)
        return b


class Simulator:
    def __init__(
        self,
        cluster: Cluster,
        network: NetworkModel = EMULAB_NETWORK,
        thrash_factor: float = THRASH_FACTOR,
        ack_overhead_s: float = ACK_OVERHEAD_S,
        tuple_timeout_s: float = TUPLE_TIMEOUT_S,
    ):
        self.cluster = cluster
        self.network = network
        self.thrash_factor = thrash_factor
        self.ack_overhead_s = ack_overhead_s
        # The steady-state fixed point never drives latency anywhere near the
        # timeout (λ = pending/L with L in milliseconds), so the solver only
        # *carries* the knob; the DES executor is where timeouts fire and
        # replays happen.  Keeping it here means both referees read one
        # config (RunSettings.tuple_timeout_s) instead of private defaults.
        self.tuple_timeout_s = tuple_timeout_s

    # -- public API -------------------------------------------------------------
    def run(self, topology: Topology, assignment: Assignment) -> SimResult:
        return self.run_many([(topology, assignment)])[topology.id]

    def run_many(
        self,
        scheduled: Sequence[Tuple[Topology, Assignment]],
        warm_start: Optional[Mapping[str, float]] = None,
    ) -> Dict[str, SimResult]:
        """Joint simulation of topologies sharing the cluster (paper §6.5).

        Gauss–Seidel: each round, re-solve each topology's λ against capacity
        minus every *other* topology's current usage, until convergence.

        ``warm_start`` maps topology_id -> a prior spout rate λ used as the
        solver's entry point — the incremental re-entry a scenario replay
        uses after each timeline event, where the new steady state is usually
        near the previous interval's.  The fixed point reached is the same;
        only the path to it shortens.
        """
        loads = [_TopologyLoad(t, a, self.cluster) for t, a in scheduled]
        thrashed = self._thrashed_nodes(loads)
        warm = warm_start or {}
        lam = [max(float(warm.get(load.topology.id, 0.0)), 0.0) for load in loads]
        for _ in range(40):
            delta = 0.0
            for i, load in enumerate(loads):
                other = [(loads[j], lam[j]) for j in range(len(loads)) if j != i]
                new = self._solve_single(
                    load, other, thrashed, init=lam[i] if lam[i] > 0.0 else None
                )
                delta = max(delta, abs(new - lam[i]))
                lam[i] = new
            if delta < 1e-6 * max(1.0, max(lam)):
                break
        out: Dict[str, SimResult] = {}
        for i, load in enumerate(loads):
            other = [(loads[j], lam[j]) for j in range(len(loads)) if j != i]
            out[load.topology.id] = self._result(load, lam[i], other, thrashed)
        return out

    # -- shared capacity helpers ---------------------------------------------------
    def _thrashed_nodes(self, loads: Sequence[_TopologyLoad]) -> List[str]:
        mem: Dict[str, float] = {}
        for load in loads:
            for nid, mb in load.memory.items():
                mem[nid] = mem.get(nid, 0.0) + mb
        return sorted(
            nid
            for nid, mb in mem.items()
            if mb > self.cluster.nodes[nid].spec.memory_capacity_mb + 1e-9
        )

    def _eff_cpu_capacity(self, nid: str, thrashed: Sequence[str]) -> float:
        cap = self.cluster.nodes[nid].spec.cpu_capacity
        return cap * self.thrash_factor if nid in thrashed else cap

    def _residual_cpu(
        self,
        nid: str,
        load: _TopologyLoad,
        lam: float,
        other: Sequence[Tuple[_TopologyLoad, float]],
        thrashed: Sequence[str],
    ) -> float:
        cap = self._eff_cpu_capacity(nid, thrashed)
        cap -= load.cpu.get(nid, 0.0) * lam
        cap -= sum(o.cpu.get(nid, 0.0) * lo for o, lo in other)
        return cap

    def _cpu_bound(
        self,
        load: _TopologyLoad,
        other: Sequence[Tuple[_TopologyLoad, float]],
        thrashed: Sequence[str],
    ) -> float:
        """Strict work-conserving bound: Σ rate×cost per node ≤ capacity."""
        nids = sorted(load.cpu)
        use = np.array([load.cpu[n] for n in nids], dtype=np.float64)
        cap = np.array(
            [
                self._eff_cpu_capacity(n, thrashed)
                - sum(o.cpu.get(n, 0.0) * lo for o, lo in other)
                for n in nids
            ],
            dtype=np.float64,
        )
        return float(capacity_bound(use, cap))

    def _bandwidth_bound(
        self,
        load: _TopologyLoad,
        other: Sequence[Tuple[_TopologyLoad, float]],
    ) -> float:
        b = math.inf
        for direction, link_bw in (
            ("egress", self.network.nic_bw),
            ("ingress", self.network.nic_bw),
            ("rack_up", self.network.rack_uplink_bw),
        ):
            mine: Dict[str, float] = getattr(load, direction)
            ids = sorted(mine)
            use = np.array([mine[i] for i in ids], dtype=np.float64)
            cap = np.array(
                [
                    link_bw
                    - sum(getattr(o, direction).get(i, 0.0) * lo for o, lo in other)
                    for i in ids
                ],
                dtype=np.float64,
            )
            b = min(b, float(capacity_bound(use, cap)))
        return b

    # -- latency / ack loop -----------------------------------------------------------
    def _task_mu(
        self,
        load: _TopologyLoad,
        comp: Component,
        nid: str,
        lam: float,
        other: Sequence[Tuple[_TopologyLoad, float]],
        thrashed: Sequence[str],
        task_id: str = "",
    ) -> float:
        """Max service rate of one task: residual node CPU (work-conserving —
        everything the colocated tasks at the current operating point leave
        over, plus its own share) ÷ per-tuple cost, capped by the intrinsic
        per-task ceiling and one core."""
        cost = _cpu_cost(comp)
        own = load.task_rate.get(task_id, 0.0) * lam * cost if task_id else 0.0
        residual = self._residual_cpu(nid, load, lam, other, thrashed) + own
        one_core = min(self.cluster.nodes[nid].spec.cpu_capacity, 100.0)
        points = max(min(residual, one_core), 0.0)
        mu = points / cost if cost > _EPS else math.inf
        if comp.max_rate_per_task is not None:
            mu = min(mu, comp.max_rate_per_task)
        return mu

    def _latency(
        self,
        load: _TopologyLoad,
        lam: float,
        other: Sequence[Tuple[_TopologyLoad, float]],
        thrashed: Sequence[str],
    ) -> float:
        """Flow-weighted critical-path latency at spout rate ``lam``."""
        topo, net = load.topology, self.network

        def egress_util(nid: str) -> float:
            use = load.egress.get(nid, 0.0) * lam
            use += sum(o.egress.get(nid, 0.0) * lo for o, lo in other)
            return min(use / net.nic_bw, 0.999)

        # Expected per-hop latency for each component edge.
        hop: Dict[Tuple[str, str], float] = {}
        for edge, flows in load.edge_flows.items():
            src_comp = topo.components[edge[0]]
            total, acc = 0.0, 0.0
            for a, b, f in flows:
                base = net.latency(self.cluster, a, b)
                if a != b:
                    ser = src_comp.tuple_bytes / net.nic_bw
                    base += ser / max(1e-3, 1.0 - egress_util(a))
                total += f
                acc += f * base
            hop[edge] = acc / total if total > _EPS else 0.0

        # Per-component service delay: flow-weighted mean over tasks of the
        # M/M/1 sojourn (a saturated task dominates through its huge delay).
        service: Dict[str, float] = {}
        for cid, comp in topo.components.items():
            if _cpu_cost(comp) <= _EPS and comp.max_rate_per_task is None:
                service[cid] = 0.0
                continue
            acc, weight = 0.0, 0.0
            for t in comp.tasks(topo.id):
                nid = load.placements.get(t.id)
                if nid is None:
                    continue
                rate = load.task_rate.get(t.id, 0.0) * lam
                mu = self._task_mu(load, comp, nid, lam, other, thrashed, t.id)
                rho = min(rate / max(mu, _EPS), RHO_CAP)
                w = max(load.task_rate.get(t.id, 0.0), _EPS)
                acc += w * (1.0 / max(mu, _EPS)) / (1.0 - rho)
                weight += w
            service[cid] = acc / weight if weight > 0 else 0.0

        # Critical path: longest (latency) source→sink path over the DAG.
        memo: Dict[str, float] = {}

        def path_from(cid: str) -> float:
            if cid in memo:
                return memo[cid]
            best = 0.0
            for d in topo.downstream(cid):
                best = max(best, hop[(cid, d)] + service.get(d, 0.0) + path_from(d))
            memo[cid] = best
            return best

        lat = 0.0
        for sp in topo.spouts:
            lat = max(lat, service.get(sp.id, 0.0) + path_from(sp.id))
        return lat + self.ack_overhead_s

    # -- load-shedding (unanchored) propagation ---------------------------------------
    def _shedding_sink_rate(
        self,
        load: _TopologyLoad,
        lam: float,
        other: Sequence[Tuple[_TopologyLoad, float]],
        thrashed: Sequence[str],
    ) -> float:
        """Saturating flow: each task processes min(arrivals, μ); excess is
        shed.  Per-task propagation along the placement-dependent routes."""
        topo = load.topology
        comp_of_task = {
            t.id: cid for cid, c in topo.components.items() for t in c.tasks(topo.id)
        }
        task_in: Dict[str, float] = {}
        comp_done: Dict[str, float] = {}
        for cid in _topo_order(topo):
            comp = topo.components[cid]
            done_c = 0.0
            for t in comp.tasks(topo.id):
                nid = load.placements.get(t.id)
                if nid is None:
                    continue
                if comp.is_spout:
                    arrive = lam / comp.parallelism
                else:
                    arrive = task_in.get(t.id, 0.0)
                mu = self._task_mu(load, comp, nid, lam, other, thrashed, t.id)
                done = min(arrive, mu)
                done_c += done
                out = done * (1.0 if comp.is_spout else comp.emit_ratio)
                routes = load.routes.get(t.id, [])
                # Distribute proportionally to the lossless routing shares;
                # a task's routes may span several downstream components.
                per_dst: Dict[str, float] = {}
                for tid, s in routes:
                    per_dst[tid] = per_dst.get(tid, 0.0) + s
                denom = load.task_rate.get(t.id, 0.0) * (
                    1.0 if comp.is_spout else comp.emit_ratio
                )
                if denom > _EPS:
                    for tid, s in per_dst.items():
                        task_in[tid] = task_in.get(tid, 0.0) + out * (s / denom)
                elif routes:
                    # Zero-lossless-rate source (a vanishing upstream emit
                    # ratio drives task_rate below _EPS while the shed flow
                    # is still nonzero): the lossless shares carry no
                    # information, so split by raw route multiplicity
                    # instead of silently dropping the downstream flow.
                    # Broadcast semantics as in the normal branch: every
                    # downstream *component* receives the full stream, so
                    # multiplicities normalize per destination component.
                    counts: Dict[str, int] = {}
                    comp_routes: Dict[str, int] = {}
                    for tid, _ in routes:
                        counts[tid] = counts.get(tid, 0) + 1
                        dc = comp_of_task[tid]
                        comp_routes[dc] = comp_routes.get(dc, 0) + 1
                    for tid, k in counts.items():
                        task_in[tid] = task_in.get(tid, 0.0) + out * (
                            k / comp_routes[comp_of_task[tid]]
                        )
            comp_done[cid] = done_c
        return sum(comp_done[s.id] for s in topo.sinks())

    # -- solvers -------------------------------------------------------------------
    def _solve_single(
        self,
        load: _TopologyLoad,
        other: Sequence[Tuple[_TopologyLoad, float]],
        thrashed: Sequence[str],
        init: Optional[float] = None,
    ) -> float:
        source = load.source_bound()
        bw = self._bandwidth_bound(load, other)
        if not load.topology.acked:
            # Unanchored: spouts push at their ceiling, bandwidth permitting.
            lam = min(source, bw)
            if not math.isfinite(lam):
                lam = self._cpu_bound(load, other, thrashed)
            return max(lam, 0.0)
        cpu = self._cpu_bound(load, other, thrashed)
        hard = min(source, bw, cpu)
        pending = load.pending()
        if init is not None and math.isfinite(init) and init > _EPS:
            # Warm re-entry: start the ack-loop iteration at the caller's
            # prior fixed point (capped by the current hard bounds).
            lam = min(init, hard) if math.isfinite(hard) else init
            lam = max(lam, _EPS)
        else:
            lam = 1.0 if not math.isfinite(hard) else max(hard * 0.25, _EPS)
        for _ in range(80):
            lat = self._latency(load, lam, other, thrashed)
            ack = pending / lat if lat > _EPS else math.inf
            target = min(hard, ack)
            if not math.isfinite(target):
                target = lam * 2.0
            new = 0.5 * (lam + target)
            if abs(new - lam) < 1e-9 * max(1.0, lam):
                lam = new
                break
            lam = new
        return max(lam, 0.0)

    def _result(
        self,
        load: _TopologyLoad,
        lam: float,
        other: Sequence[Tuple[_TopologyLoad, float]],
        thrashed: Sequence[str],
    ) -> SimResult:
        topo = load.topology
        bounds = {
            "source": load.source_bound(),
            "bandwidth": self._bandwidth_bound(load, other),
            "cpu": self._cpu_bound(load, other, thrashed),
        }
        lat = self._latency(load, lam, other, thrashed)
        bounds["ack"] = (
            load.pending() / lat if (topo.acked and lat > _EPS) else math.inf
        )
        finite = {k: v for k, v in bounds.items() if math.isfinite(v)}
        binding = min(finite, key=lambda k: finite[k]) if finite else "source"
        # Placement-aware sink rate: per-unit-λ processed rates of the sink
        # *tasks* actually placed on live nodes (task_rate only ever contains
        # those), so a partially-orphaned topology reports the flow its
        # surviving tasks carry — and zero once nothing is placed.
        lossless = (
            sum(
                load.task_rate.get(t.id, 0.0)
                for s in topo.sinks()
                for t in s.tasks(topo.id)
            )
            * lam
        )
        if topo.acked:
            sink_tp = lossless
        else:
            sink_tp = self._shedding_sink_rate(load, lam, other, thrashed)
            # Attribution: if shedding lost >10% of the lossless flow, CPU
            # (or thrash) was the binding mechanism.
            if sink_tp < 0.9 * lossless:
                binding = "cpu"
        # CPU utilization across machines hosting ≥1 task of *this* topology
        # (paper Fig 10 averages over the machines the scheduler used).
        node_util: Dict[str, float] = {}
        for nid in load.nodes_used():
            use = load.cpu.get(nid, 0.0) * lam
            use += sum(o.cpu.get(nid, 0.0) * lo for o, lo in other)
            node_util[nid] = min(
                use / self.cluster.nodes[nid].spec.cpu_capacity, 1.0
            )
        avg_util = sum(node_util.values()) / len(node_util) if node_util else 0.0
        return SimResult(
            topology_id=topo.id,
            spout_rate=lam,
            sink_throughput=sink_tp,
            binding=binding,
            latency_s=lat,
            machines_used=len(load.nodes_used()),
            avg_cpu_utilization=avg_util,
            node_cpu_utilization=node_util,
            thrashed_nodes=list(thrashed),
            bounds=bounds,
        )


def simulate(
    topology: Topology,
    assignment: Assignment,
    cluster: Cluster,
    network: NetworkModel = EMULAB_NETWORK,
) -> SimResult:
    return Simulator(cluster, network).run(topology, assignment)
