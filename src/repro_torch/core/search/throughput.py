"""Batched throughput proxy — search what the paper measures (§6).

The paper's headline claims are about *sink throughput*, but network cost is
only a proxy that diverges exactly in the CPU-bound and shedding regimes
(§6.3.2, §6.5).  This module distills the simulator's binding analysis
(:mod:`repro_torch.stream.simulator`) into a per-candidate bound that is
one batched torch reduction over a ``(B, T)`` placement batch:

    proxy(p) = min(source, cpu(p), bandwidth(p), ack(p)) × lossless sink rate

* **source** — the placement-independent λ ceiling from intrinsic per-task
  rates (``max_rate_per_task``);
* **cpu(p)** — segment-sum the per-task CPU cost rows onto nodes, divide
  into per-node *effective* capacity (memory over-subscription thrashes a
  node to ``thrash_factor`` of its CPU, the §6.5 collapse mechanism);
* **bandwidth(p)** — edge-gather per-link flow: per-NIC egress/ingress and
  per-rack uplink bytes per unit λ against link capacity;
* **ack(p)** — first-order credit loop for acked topologies:
  ``pending / L₀(p)`` with L₀ the *zero-load* critical-path latency
  (flow-weighted hop latencies by placement class + per-component service
  at free capacity + the constant acker round trip).  The queueing-aware
  refinement (utilization-inflated serialization, M/M/1 sojourn at the
  operating point) is a recorded ROADMAP follow-up.

The per-task rates are the simulator's *lossless* component rates under a
uniform shuffle split (placement-independent by construction — what makes
the whole bound a gather/segment-sum instead of a fixed-point solve).  The
evaluator models Storm's ``local_or_shuffle`` locality routing for the
bandwidth/ack terms: a src task with a colocated dst routes everything
locally (no NIC bytes, intra-node latency), computed per candidate via one
extra segment-sum of colocation counts.  The annealer's O(degree)
incremental hot loop keeps the uniform-split approximation (locality flips
have non-local state effects); the scheduler's final candidate selection
and the never-worse-than-greedy check use this faithful evaluator.

Exactness contract (the same golden-equality bar as ``evaluate_batch``):
every per-task rate/flow is quantized to a dyadic grid at compile time
(``GRID`` for resource rows, the finer ``ACK_GRID`` for latency×flow
summands), so all segment-sums are exact integer arithmetic in float64 —
the sum order (``index_add_``, ``scatter_add_``, CUDA atomics) cannot change
a bit, and the port is bit-identical to the reference's numpy backend.

The compile (``compile_throughput``) is the reference's numpy code; the
evaluation functions below are its torch forms and take a model uploaded
with ``ThroughputModel.to(device)``.  Two torch habits would break the
bit-identity and are avoided throughout: ``float / tensor`` rounds twice
(it is ``reciprocal() * float``), so scalar numerators are expanded with
``full_like`` first; and ``alpha=``/``addcmul``/``lerp`` would contract a
multiply into an add.  The scalar
simulator reuses :func:`capacity_bound` for its own per-node bounds, so the
proxy and the simulator share one source of truth for "binding bound"
semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .backend import DeviceLike, as_tensor, resolve_device
from .batch import BatchArena

_EPS = 1e-12
_INF = float("inf")

#: Dyadic quantization grid for per-task rates/flows: values become exact
#: multiples of 2^-26, so segment-sums (of realistically bounded magnitude)
#: are exact in float64 regardless of accumulation order — the structural
#: guarantee behind the port's bit-equality with the reference.
GRID = 2.0 ** -26

#: Finer grid for latency×flow summands (magnitudes ~1e-8..1e-2); sums stay
#: exact while below 2^53 × ACK_GRID ≈ 32 seconds of aggregate latency.
ACK_GRID = 2.0 ** -48


def quantize(x: np.ndarray, grid: float = GRID) -> np.ndarray:
    """Round to a dyadic grid (float64, exact representation)."""
    return np.round(np.asarray(x, dtype=np.float64) / grid) * grid


@dataclasses.dataclass(frozen=True)
class AckPlan:
    """Static (hashable) description of the zero-load ack-loop bound.

    ``dp`` drives the unrolled critical-path recursion: for each component
    (reverse topological order) the tuple of ``(comp_edge_index, downstream
    component index)`` pairs; ``svc`` is the per-component zero-load service
    delay; ``spouts`` the component indices the path maximum starts from.
    The kernel wrapper flattens it into one int32 table.
    """

    acked: bool
    pending: float
    ack_overhead_s: float
    svc: Tuple[float, ...]
    spouts: Tuple[int, ...]
    dp: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]
    n_comp_edges: int


@dataclasses.dataclass(frozen=True)
class ThroughputModel:
    """Per-(topology, cluster) arrays the proxy reduces over.

    All per-task quantities are grid-quantized; all arrays are aligned with
    the owning ``BatchArena`` (``tids`` task order, ``node_ids`` node order,
    ``edges`` edge order, ``adj`` adjacency slots).  Arrays are numpy after
    ``compile_throughput`` and torch tensors after ``to(device)``.
    """

    task_cpu: np.ndarray   # (T,) CPU points per unit λ (rate × cost)
    task_mem: np.ndarray   # (T,) memory MB (static)
    cpu_cap: np.ndarray    # (N,) CPU points
    mem_cap: np.ndarray    # (N,) memory MB
    rack_of: np.ndarray    # (N,) intp rack index
    n_racks: int
    edge_bytes: np.ndarray  # (E,) bytes/s per unit λ, aligned with ba.edges
    edge_comp: np.ndarray   # (E,) intp component-edge index per task edge
    edge_lat: np.ndarray    # (3, E) latency×flow summands per placement class
    den_flow: np.ndarray    # (n_comp_edges,) flow sums (hop-mean denominators)
    # Storm locality routing (local_or_shuffle): a src task with ≥1
    # colocated dst task routes *everything* locally — its pairs carry no
    # NIC bytes and intra-node latency.  ``pair_key`` maps each task edge
    # to its (src task, comp edge) combo; ``local_num`` is the combo's
    # quantized out-rate × intra-node latency (its ack contribution while
    # locally routed; zero for shuffle combos).
    edge_local: np.ndarray  # (E,) bool — src component edge is local_or_shuffle
    pair_key: np.ndarray    # (E,) intp combo index
    combo_ce: np.ndarray    # (K,) intp comp-edge per combo
    local_num: np.ndarray   # (K,) float64
    n_combos: int
    adj_bytes: np.ndarray   # (T, max_deg) per-slot edge bytes, aligned with ba.adj
    adj_src: np.ndarray     # (T, max_deg) True where the row task is the edge src
    adj_comp: np.ndarray    # (T, max_deg) intp component-edge index per slot
    adj_lat: np.ndarray     # (3, T, max_deg) latency×flow summands per slot
    ack: AckPlan
    nic_bw: float
    rack_bw: float
    thrash_factor: float
    source_bound: float    # scalar λ ceiling (inf when no component is rate-limited)
    sink_rate: float       # lossless per-unit-λ sink processing rate

    @property
    def nic_cap(self) -> torch.Tensor:
        return torch.full(
            (self.cpu_cap.shape[0],), self.nic_bw, dtype=torch.float64,
            device=self.cpu_cap.device,
        )

    @property
    def rack_cap(self) -> torch.Tensor:
        return torch.full(
            (max(self.n_racks, 1),), self.rack_bw, dtype=torch.float64,
            device=self.cpu_cap.device,
        )

    @classmethod
    def from_numpy(cls, fields: Dict, device: DeviceLike = None) -> "ThroughputModel":
        """An uploaded model from plain numpy arrays and scalars (e.g.
        ``dataclasses.asdict`` of a reference ``ThroughputModel``); the
        ``AckPlan`` travels as a plain dict."""
        ack = fields["ack"]
        if not isinstance(ack, AckPlan):
            ack = AckPlan(
                acked=bool(ack["acked"]),
                pending=float(ack["pending"]),
                ack_overhead_s=float(ack["ack_overhead_s"]),
                svc=tuple(float(x) for x in ack["svc"]),
                spouts=tuple(int(x) for x in ack["spouts"]),
                dp=tuple(
                    (int(ci), tuple((int(ce), int(d)) for ce, d in downs))
                    for ci, downs in ack["dp"]
                ),
                n_comp_edges=int(ack["n_comp_edges"]),
            )
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in fields.items() if k in names}
        return cls(**{**kw, "ack": ack}).to(device)

    def to(self, device: DeviceLike = None) -> "ThroughputModel":
        """A copy with every array uploaded to ``device`` (``None`` = the card)."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            **{
                f.name: as_tensor(getattr(self, f.name), dev)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), (np.ndarray, torch.Tensor))
            },
        )


def lossless_task_profile(topology):
    """(per-task rate, per-task-edge flow) under the lossless uniform split.

    Returns ``(rates, flows)`` where ``rates[tid]`` is the per-unit-λ
    processed rate of one task (spouts: emitted) and ``flows[(src_cid,
    dst_cid)]`` is the per-unit-λ tuple flow on one (src task, dst task)
    pair of that component edge.  Placement-independent: shuffle semantics
    split each task's output uniformly over all downstream tasks.
    """
    from ...stream.simulator import _component_rates  # stream imports core; lazy here

    rate_in, rate_out = _component_rates(topology)
    rates = {}
    for cid, comp in topology.components.items():
        r = rate_out[cid] if comp.is_spout else rate_in[cid]
        per_task = r / comp.parallelism
        for t in comp.tasks(topology.id):
            rates[t.id] = per_task
    flows = {}
    for src, dst in topology.edges:
        cs, cd = topology.components[src], topology.components[dst]
        flows[(src, dst)] = rate_out[src] / (cs.parallelism * cd.parallelism)
    return rates, flows


def _ack_plan(topology, cluster, ce_of, ack_overhead_s) -> AckPlan:
    """Compile the static critical-path recursion for the ack bound."""
    from ...stream.simulator import _cpu_cost, _topo_order

    order = _topo_order(topology)
    cindex = {cid: k for k, cid in enumerate(order)}
    live_caps = [n.spec.cpu_capacity for n in cluster.live_nodes()]
    one_core = min(min(live_caps) if live_caps else 100.0, 100.0)
    svc = []
    for cid in order:
        comp = topology.components[cid]
        cost = _cpu_cost(comp)
        mu = one_core / cost if cost > _EPS else np.inf
        if comp.max_rate_per_task is not None:
            mu = min(mu, comp.max_rate_per_task)
        svc.append(1.0 / mu if np.isfinite(mu) and mu > _EPS else 0.0)
    dp = tuple(
        (
            cindex[cid],
            tuple(
                (ce_of[(cid, d)], cindex[d]) for d in topology.downstream(cid)
            ),
        )
        for cid in reversed(order)
    )
    pending = sum(
        topology.max_spout_pending * c.parallelism for c in topology.spouts
    )
    return AckPlan(
        acked=bool(topology.acked),
        pending=float(pending),
        ack_overhead_s=float(ack_overhead_s),
        svc=tuple(svc),
        spouts=tuple(cindex[c.id] for c in topology.spouts),
        dp=dp,
        n_comp_edges=len(ce_of),
    )


def compile_throughput(
    ba: BatchArena,
    topology,
    cluster,
    network=None,
    thrash_factor: Optional[float] = None,
) -> ThroughputModel:
    """Compile the proxy arrays for one ``BatchArena``.

    ``network`` defaults to the paper's Emulab model; ``thrash_factor`` and
    the ack overhead to the simulator's constants (so proxy and simulator
    agree on the §6.5 collapse mechanism and the credit loop).
    """
    from ...stream.simulator import ACK_OVERHEAD_S, THRASH_FACTOR, _cpu_cost
    from ...stream.network import EMULAB_NETWORK

    if network is None:
        network = EMULAB_NETWORK
    if thrash_factor is None:
        thrash_factor = THRASH_FACTOR
    if ba.rack_of is None:
        raise ValueError("BatchArena was compiled without rack information")

    rates, flows = lossless_task_profile(topology)
    comps = topology.components
    tindex = {tid: i for i, tid in enumerate(ba.tids)}

    task_cpu = np.zeros(ba.n_tasks, dtype=np.float64)
    task_mem = np.zeros(ba.n_tasks, dtype=np.float64)
    for t in topology.all_tasks():
        i = tindex.get(t.id)
        if i is None:
            continue
        comp = comps[t.component_id]
        # Same units as _TopologyLoad._build: points per unit λ.
        task_cpu[i] = rates[t.id] * _cpu_cost(comp)
        task_mem[i] = comp.memory_load

    ce_of = {edge: k for k, edge in enumerate(topology.edges)}

    # Per-task-edge arrays, replaying BatchArena.from_arena's edge loop so
    # rows align with ba.edges and slots with ba.adj.  The three edge_lat
    # rows are the quantized latency×flow summands for the placement
    # classes (same node / same rack / inter-rack); crossing classes carry
    # the zero-load serialization delay.
    E = ba.edges.shape[0]
    edge_bytes = np.zeros(E, dtype=np.float64)
    edge_comp = np.zeros(E, dtype=np.intp)
    edge_lat = np.zeros((3, E), dtype=np.float64)
    edge_local = np.zeros(E, dtype=bool)
    pair_key = np.zeros(E, dtype=np.intp)
    combo_index: dict = {}
    combo_ce_list: List[int] = []
    local_num_list: List[float] = []
    adj_bytes = np.zeros(ba.adj.shape, dtype=np.float64)
    adj_src = np.zeros(ba.adj.shape, dtype=bool)
    adj_comp = np.zeros(ba.adj.shape, dtype=np.intp)
    adj_lat = np.zeros((3,) + ba.adj.shape, dtype=np.float64)
    slot = [0] * ba.n_tasks
    e = 0
    for src, dst in topology.task_edges():
        a, b = tindex.get(src.id), tindex.get(dst.id)
        if a is None or b is None:
            continue
        cs = comps[src.component_id]
        cedge = (src.component_id, dst.component_id)
        flow = flows[cedge]
        byt = float(quantize(flow * cs.tuple_bytes))
        ser = cs.tuple_bytes / network.nic_bw
        lat3 = quantize(
            np.array(
                [
                    network.lat_inter_process * flow,
                    (network.lat_inter_node + ser) * flow,
                    (network.lat_inter_rack + ser) * flow,
                ]
            ),
            ACK_GRID,
        )
        ce = ce_of[cedge]
        is_local = topology.groupings.get(cedge, "shuffle") == "local_or_shuffle"
        combo = (a, ce)
        if combo not in combo_index:
            combo_index[combo] = len(combo_ce_list)
            combo_ce_list.append(ce)
            # Per-src-task ack contribution while locally routed: the whole
            # out rate traverses intra-node hops (only local combos use it).
            n_dst = comps[dst.component_id].parallelism
            local_num_list.append(
                float(
                    quantize(flow * n_dst * network.lat_inter_process, ACK_GRID)
                )
                if is_local
                else 0.0
            )
        assert ba.adj[a, slot[a]] == b and ba.adj[b, slot[b]] == a
        edge_bytes[e] = byt
        edge_comp[e] = ce
        edge_lat[:, e] = lat3
        edge_local[e] = is_local
        pair_key[e] = combo_index[combo]
        for r, is_src in ((a, True), (b, False)):
            adj_bytes[r, slot[r]] = byt
            adj_src[r, slot[r]] = is_src
            adj_comp[r, slot[r]] = ce
            adj_lat[:, r, slot[r]] = lat3
            slot[r] += 1
        e += 1
    combo_ce = (
        np.array(combo_ce_list, dtype=np.intp)
        if combo_ce_list
        else np.zeros(1, dtype=np.intp)
    )
    local_num = (
        np.array(local_num_list, dtype=np.float64)
        if local_num_list
        else np.zeros(1, dtype=np.float64)
    )

    den_flow = np.zeros(max(len(ce_of), 1), dtype=np.float64)
    q_flows = {edge: float(quantize(f, ACK_GRID)) for edge, f in flows.items()}
    for src, dst in topology.task_edges():
        if src.id in tindex and dst.id in tindex:
            den_flow[ce_of[(src.component_id, dst.component_id)]] += q_flows[
                (src.component_id, dst.component_id)
            ]

    source = np.inf
    for comp in comps.values():
        if comp.max_rate_per_task is None:
            continue
        r = rates[comp.tasks(topology.id)[0].id]  # equal across the component
        if r > _EPS:
            source = min(source, comp.max_rate_per_task / r)
    sink_rate = sum(
        rates[t.id] for s in topology.sinks() for t in s.tasks(topology.id)
    )

    cpu_cap = np.array(
        [cluster.nodes[nid].spec.cpu_capacity for nid in ba.node_ids], dtype=np.float64
    )
    mem_cap = np.array(
        [cluster.nodes[nid].spec.memory_capacity_mb for nid in ba.node_ids],
        dtype=np.float64,
    )
    return ThroughputModel(
        task_cpu=quantize(task_cpu),
        task_mem=quantize(task_mem),
        cpu_cap=cpu_cap,
        mem_cap=mem_cap,
        rack_of=ba.rack_of.astype(np.intp),
        n_racks=int(ba.n_racks),
        edge_bytes=edge_bytes,
        edge_comp=edge_comp,
        edge_lat=edge_lat,
        den_flow=den_flow,
        edge_local=edge_local,
        pair_key=pair_key,
        combo_ce=combo_ce,
        local_num=local_num,
        n_combos=max(len(combo_ce_list), 1),
        adj_bytes=adj_bytes,
        adj_src=adj_src,
        adj_comp=adj_comp,
        adj_lat=adj_lat,
        ack=_ack_plan(topology, cluster, ce_of, ACK_OVERHEAD_S),
        nic_bw=float(network.nic_bw),
        rack_bw=float(network.rack_uplink_bw),
        thrash_factor=float(thrash_factor),
        source_bound=float(source),
        sink_rate=float(sink_rate),
    )


# -- torch evaluation ----------------------------------------------------------
def capacity_bound(use, cap) -> torch.Tensor:
    """λ ceiling from ``use × λ ≤ cap`` per entry, reduced over the trailing
    axis: ``min over entries with use > eps of max(cap, 0) / use`` (``inf``
    when nothing binds).

    The one array-form "binding bound" both the scalar simulator
    (``Simulator._cpu_bound`` / ``_bandwidth_bound``, which pass numpy
    arrays) and the batched proxy compute — so the two cannot drift.  The
    appended ``inf`` column stands in for numpy's ``min(initial=inf)``.
    """
    use = torch.as_tensor(use, dtype=torch.float64)
    cap = torch.as_tensor(cap, dtype=torch.float64, device=use.device)
    binds = use > _EPS
    ratio = torch.where(
        binds, cap.clamp_min(0.0) / torch.where(binds, use, 1.0), _INF
    )
    pad = torch.full(
        ratio.shape[:-1] + (1,), _INF, dtype=torch.float64, device=use.device
    )
    return torch.cat([ratio, pad], dim=-1).amin(dim=-1)


def ack_lambda(num: torch.Tensor, den: torch.Tensor, plan: AckPlan) -> torch.Tensor:
    """λ ceiling from the credit loop: pending / L₀, where the hop latency
    of component edge *k* is ``num[..., k] / den[k]`` (flow-weighted mean
    over its task pairs) and L₀ is the critical spout→sink path.

    ``num`` has trailing axis ``max(n_comp_edges, 1)`` (leading axes
    broadcast); returns that leading shape, all ``inf`` for unanchored
    topologies.  The addition order is the reference's:
    ``(hop + svc) + path``.
    """
    if not plan.acked:
        return torch.full_like(num[..., 0], _INF)
    pos = den > 0.0
    hop = torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)
    zeros = hop[..., 0] * 0.0
    path = {}
    for ci, downs in plan.dp:
        best = zeros
        for ce, d in downs:
            best = torch.maximum(best, hop[..., ce] + plan.svc[d] + path[d])
        path[ci] = best
    L = zeros
    for sp in plan.spouts:
        L = torch.maximum(L, plan.svc[sp] + path[sp])
    denom = L + plan.ack_overhead_s
    return torch.full_like(denom, plan.pending) / denom


def hard_lambda(
    cpu_load, mem_used, egress, ingress, rack_up,
    cpu_cap, mem_cap, nic_cap, rack_cap,
    thrash_factor: float, source_bound: float,
) -> torch.Tensor:
    """min(source, cpu, bandwidth) from per-node/per-rack aggregates
    (trailing axis = nodes/racks; leading axes broadcast — ``(B, N)``
    batches or ``(N,)`` singles).  Shared by the batched evaluator and the
    annealer's hot loop."""
    eff_cap = torch.where(mem_used > mem_cap + 1e-9, cpu_cap * thrash_factor, cpu_cap)
    b = capacity_bound(cpu_load, eff_cap)
    b = torch.minimum(b, capacity_bound(egress, nic_cap))
    b = torch.minimum(b, capacity_bound(ingress, nic_cap))
    b = torch.minimum(b, capacity_bound(rack_up, rack_cap))
    return b.clamp_max(source_bound)


def edge_lat_class(src_n, dst_n, rack_of, edge_lat) -> torch.Tensor:
    """Select the latency×flow summand per task edge from its placement
    class (gather rows of the precompiled (3, ...) quantized table)."""
    same_node = src_n == dst_n
    same_rack = rack_of[src_n] == rack_of[dst_n]
    return torch.where(
        same_node, edge_lat[0], torch.where(same_rack, edge_lat[1], edge_lat[2])
    )


def segment_sum(idx: torch.Tensor, val: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row segment sum: ``out[b, k] = Σ val[b, x] over idx[b, x] == k``
    for a ``(B, X)`` index batch (``val`` broadcasts to it) → ``(B, n)``.
    Exact in any order for grid-quantized values."""
    B = idx.shape[0]
    flat = (
        torch.arange(B, dtype=torch.int64, device=idx.device)[:, None] * n + idx
    ).reshape(-1)
    out = torch.zeros(B * n, dtype=torch.float64, device=idx.device)
    out.index_add_(0, flat, val.expand(idx.shape).reshape(-1))
    return out.reshape(B, n)


def aggregates(ba: BatchArena, tm: ThroughputModel, P: torch.Tensor):
    """(cpu_load, mem_used, egress, ingress, rack_up, ack_num) for a
    ``(B, T)`` batch — the carried state of the throughput objective
    (uniform-split routing, like the reference's ``aggregates_numpy``)."""
    B = P.shape[0]
    N, R = ba.n_nodes, max(tm.n_racks, 1)
    CE = max(tm.ack.n_comp_edges, 1)
    cpu_load = segment_sum(P, tm.task_cpu, N)
    mem_used = segment_sum(P, tm.task_mem, N)
    if not ba.edges.shape[0]:
        z = lambda n: torch.zeros(B, n, dtype=torch.float64, device=P.device)  # noqa: E731
        return cpu_load, mem_used, z(N), z(N), z(R), z(CE)
    src_n = P[:, ba.edges[:, 0]]
    dst_n = P[:, ba.edges[:, 1]]
    w = torch.where(src_n != dst_n, tm.edge_bytes, 0.0)
    egress = segment_sum(src_n, w, N)
    ingress = segment_sum(dst_n, w, N)
    rs, rd = tm.rack_of[src_n], tm.rack_of[dst_n]
    rack_up = segment_sum(rs, torch.where(rs != rd, tm.edge_bytes, 0.0), R)
    lat = edge_lat_class(src_n, dst_n, tm.rack_of, tm.edge_lat[:, None, :])
    ack_num = segment_sum(tm.edge_comp.expand(src_n.shape), lat, CE)
    return cpu_load, mem_used, egress, ingress, rack_up, ack_num


def proxy_from_state(
    cpu_load, mem_used, egress, ingress, rack_up, ack_num, tm: ThroughputModel,
    nic_cap: Optional[torch.Tensor] = None, rack_cap: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The full proxy from carried aggregates (leading axes broadcast).
    ``nic_cap``/``rack_cap`` default to the model's; a hot loop passes
    them in once."""
    lam = hard_lambda(
        cpu_load, mem_used, egress, ingress, rack_up,
        tm.cpu_cap, tm.mem_cap,
        tm.nic_cap if nic_cap is None else nic_cap,
        tm.rack_cap if rack_cap is None else rack_cap,
        tm.thrash_factor, tm.source_bound,
    )
    lam = torch.minimum(lam, ack_lambda(ack_num, tm.den_flow, tm.ack))
    return lam * tm.sink_rate


def swap_state_terms(
    P, bidx, i, j, na, nb, adj, adj_bytes, adj_src, adj_comp, adj_lat, rack_of,
):
    """Scatter terms updating the carried throughput state for swapping the
    nodes of task rows ``i`` (na→nb) and ``j`` (nb→na), per chain.

    Returns ``(eg_idx, eg_val, in_idx, in_val, rk_idx, rk_val, ce_idx,
    ce_val)``, each ``(B, 4·max_deg)``: old contributions of the incident
    edges negated, new contributions positive.  Mutual i–j edges appear in
    both adjacency rows and are halved (0.5× a grid value is exact), so
    their total stays right; padded slots carry zero weights throughout.
    """
    col = bidx[:, None]
    parts = []
    for r, pos_old, pos_new, other, other_new in (
        (i, na, nb, j, na),
        (j, nb, na, i, nb),
    ):
        nbr = adj[r]
        w = adj_bytes[r]
        is_src = adj_src[r]
        ce = adj_comp[r]
        l0, l1, l2 = adj_lat[0][r], adj_lat[1][r], adj_lat[2][r]
        mutual = nbr == other[:, None]
        half = torch.where(mutual, 0.5, 1.0).to(torch.float64)
        nbr_old = P[col, torch.where(nbr >= 0, nbr, 0)]
        nbr_new = torch.where(mutual, other_new[:, None], nbr_old)
        for pos_r, nbr_pos, sign in (
            (pos_old, nbr_old, -1.0),
            (pos_new, nbr_new, 1.0),
        ):
            src = torch.where(is_src, pos_r[:, None], nbr_pos)
            dst = torch.where(is_src, nbr_pos, pos_r[:, None])
            same_node = src == dst
            v = sign * half * torch.where(same_node, 0.0, w)
            rs, rd = rack_of[src], rack_of[dst]
            same_rack = rs == rd
            vr = sign * half * torch.where(same_rack, 0.0, w)
            vl = sign * half * torch.where(
                same_node, l0, torch.where(same_rack, l1, l2)
            )
            parts.append((src, v, dst, v, rs, vr, ce, vl))
    return tuple(torch.cat([p[k] for p in parts], dim=1) for k in range(8))


def locality_proxy(ba: BatchArena, tm: ThroughputModel, P: torch.Tensor) -> torch.Tensor:
    """Locality-aware proxy for a ``(B, T)`` batch — the faithful evaluator
    (the annealer's carried state keeps the uniform-split approximation;
    see the module docstring).  The torch form of the reference's
    ``_locality_chunk_numpy``."""
    B = P.shape[0]
    N, R = ba.n_nodes, max(tm.n_racks, 1)
    CE, K = max(tm.ack.n_comp_edges, 1), tm.n_combos
    cpu_load = segment_sum(P, tm.task_cpu, N)
    mem_used = segment_sum(P, tm.task_mem, N)
    if not ba.edges.shape[0]:
        z = lambda n: torch.zeros(B, n, dtype=torch.float64, device=P.device)  # noqa: E731
        return proxy_from_state(cpu_load, mem_used, z(N), z(N), z(R), z(CE), tm)
    src_n = P[:, ba.edges[:, 0]]
    dst_n = P[:, ba.edges[:, 1]]
    colo = src_n == dst_n
    L = segment_sum(tm.pair_key.expand(src_n.shape), colo.to(torch.float64), K)
    L_pair = L[:, tm.pair_key]  # (B, E) gather of each pair's combo count
    routed_local = tm.edge_local & (L_pair > 0.0)
    w = torch.where(~colo & ~routed_local, tm.edge_bytes, 0.0)
    egress = segment_sum(src_n, w, N)
    ingress = segment_sum(dst_n, w, N)
    rs, rd = tm.rack_of[src_n], tm.rack_of[dst_n]
    wr = torch.where((rs != rd) & ~routed_local, tm.edge_bytes, 0.0)
    rack_up = segment_sum(rs, wr, R)
    lat = torch.where(
        routed_local,
        0.0,
        edge_lat_class(src_n, dst_n, tm.rack_of, tm.edge_lat[:, None, :]),
    )
    ack_num = segment_sum(tm.edge_comp.expand(src_n.shape), lat, CE)
    ln = torch.where(L > 0.0, tm.local_num, 0.0)
    ack_num = ack_num + segment_sum(tm.combo_ce.expand(ln.shape), ln, CE)
    return proxy_from_state(
        cpu_load, mem_used, egress, ingress, rack_up, ack_num, tm
    )


def throughput_batch(
    ba: BatchArena,
    tm: ThroughputModel,
    placements,
    chunk: int = 256,
) -> torch.Tensor:
    """(B,) throughput proxy (tuples/s) for a ``(B, T)`` candidate batch
    (or one ``(T,)`` row), on the uploaded arena's device.  On the card it
    is the fused kernel's fourth output; netcost/capacity/dead ride along
    in the same pass."""
    from .objective import evaluate_batch  # objective imports this module

    return evaluate_batch(ba, placements, chunk=chunk, throughput_model=tm).throughput
