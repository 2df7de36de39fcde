"""Batched multi-start annealing over candidate placements.

B independent chains run pairwise-swap local search *simultaneously*: each
step proposes one swap per chain, scores it with the same O(degree)
incremental delta the sequential ``SwapAnnealer`` uses
(:func:`repro_torch.core.engine.arena.swap_network_delta`), and accepts it
under a threshold-accepting schedule (Dueck & Scheuer's deterministic cousin
of simulated annealing): a swap is accepted iff

    Δ(net + penalty × hard-violation)  ≤  threshold(step)

with the threshold annealing linearly to 0, where the loop becomes pure
hill-climbing.  No ``exp``/``log`` in the hot loop: the accept decision is a
comparison of *exact* float64 quantities, so the chains are bit-identical to
the reference's numpy backend on any device.

All randomness (swap proposals) is pregenerated with numpy's Philox
generator from one seed and uploaded once, as is the threshold schedule
(``np.linspace``: ``torch.linspace`` rounds differently).  The step loop is
a Python loop of eager torch ops on the arena's device; it never reads a
value back to the host, so on the card it only enqueues kernels.  Eager ops
do not fuse, so no multiply is contracted into an add.

Because violations are penalized at ``OVERLOAD_PENALTY`` (≫ any threshold),
chains seeded with feasible placements stay feasible at every step, while
infeasible seeds (random init) are driven toward feasibility first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..engine.arena import swap_network_delta
from .batch import BatchArena
from .objective import OVERLOAD_PENALTY, as_batch
from .throughput import (
    ThroughputModel,
    aggregates,
    hard_lambda,
    ack_lambda,
    proxy_from_state,
    swap_state_terms,
)

#: Registry-visible objective modes for the batched annealer / search.
OBJECTIVES = ("netcost", "throughput")

#: Initial accept threshold, in net-distance hops: early steps may accept
#: swaps that worsen the placement by up to this much, escaping the greedy
#: seed's local minimum; anneals linearly to 0.
DEFAULT_T0 = 2.0


def swap_overload_delta(cap_a, cap_b, used_a, used_b, dem_i, dem_j) -> torch.Tensor:
    """Hard-dimension overload delta for a swap on ``(B, Dh)`` per-chain
    rows, summing the per-dim relu terms over the trailing axis (the torch
    form of the engine's ``swap_overload_delta``, same operation order)."""
    ua2 = used_a - dem_i + dem_j
    ub2 = used_b - dem_j + dem_i
    d = (
        (ua2 - cap_a).clamp_min(0.0)
        - (used_a - cap_a).clamp_min(0.0)
        + (ub2 - cap_b).clamp_min(0.0)
        - (used_b - cap_b).clamp_min(0.0)
    )
    return d.sum(dim=-1)


def move_delta(move_cost, move_base, i, j, na, nb) -> torch.Tensor:
    """Δ(migration term) for swapping tasks ``i``/``j`` between nodes
    ``na``/``nb``: each task's penalty toggles on whether its new node
    matches its pre-move node.  With all-zero costs the result is ±0.0,
    which is bitwise inert on the accept comparisons."""
    f64 = torch.float64
    ci, cj = move_cost[i], move_cost[j]
    bi, bj = move_base[i], move_base[j]
    return ci * ((nb != bi).to(f64) - (na != bi).to(f64)) + cj * (
        (na != bj).to(f64) - (nb != bj).to(f64)
    )


def swap_proposals(
    n_tasks: int, steps: int, n_chains: int, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pregenerated (i, j) task-index proposals, shape (steps, B) each.

    ``j = (i + offset) % T`` with offset ≥ 1 guarantees i ≠ j.  Philox is
    counter-based, so the stream is stable across numpy versions/platforms.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    ii = rng.integers(0, n_tasks, size=(steps, n_chains), dtype=np.int64)
    off = rng.integers(1, max(n_tasks, 2), size=(steps, n_chains), dtype=np.int64)
    return ii, (ii + off) % n_tasks


class BatchAnnealer:
    """Run B swap-search chains in lockstep on one uploaded BatchArena."""

    def __init__(self, ba: BatchArena):
        self.ba = ba

    def run(
        self,
        P0,
        steps: int,
        seed: int,
        t0: float = DEFAULT_T0,
        objective: str = "netcost",
        tm: Optional[ThroughputModel] = None,
    ) -> torch.Tensor:
        """Anneal every chain of ``P0`` (B, T) for ``steps`` proposals each;
        returns the final (B, T) int64 batch on the arena's device.

        ``objective="netcost"`` (default) accepts on Δ(net + penalty ×
        violation) ≤ threshold.  ``objective="throughput"`` (requires an
        uploaded ``ThroughputModel``) *maximizes* the throughput proxy with
        netcost as the annealed tie-break: a swap is accepted iff it reduces
        hard violation, or — violation unchanged — raises the proxy, or —
        proxy unchanged — passes the netcost threshold test.
        """
        if objective not in OBJECTIVES:
            raise ValueError(
                f"unknown objective {objective!r}; choose from {OBJECTIVES}"
            )
        if objective == "throughput" and tm is None:
            raise ValueError("objective='throughput' requires a ThroughputModel")
        ba = self.ba
        P0 = as_batch(ba, P0)
        n_chains, n_tasks = P0.shape
        if n_tasks < 2 or (ba.edges.numel() == 0 and ba.avail.numel() == 0):
            return P0.clone()  # nothing a swap could improve
        dev = ba.device
        ii, jj = swap_proposals(n_tasks, steps, n_chains, seed)
        ii = torch.as_tensor(ii, device=dev)
        jj = torch.as_tensor(jj, device=dev)
        thresh = torch.as_tensor(np.linspace(float(t0), 0.0, steps), device=dev)
        if objective == "throughput":
            return self._run_tp(P0, ii, jj, thresh, tm)
        return self._run_netcost(P0, ii, jj, thresh)

    def _swap_terms(self, P, used, bidx, i, j):
        """Per-chain node pair, network delta, migration delta (None without
        a move term) and overload delta of proposal (i, j) — the part both
        objectives share."""
        ba = self.ba
        col = bidx[:, None]
        na, nb = P[bidx, i], P[bidx, j]
        ai, mi = ba.adj[i], ba.adj_mask[i]
        aj, mj = ba.adj[j], ba.adj_mask[j]
        pa = P[col, torch.where(mi, ai, 0)]
        pb = P[col, torch.where(mj, aj, 0)]
        m_ab = ((ai == j[:, None]) & mi).sum(dim=-1)
        dnet = swap_network_delta(ba.net, na, nb, pa, pb, m_ab, mi, mj, xp=torch)
        dmove = (
            None if ba.move_cost is None
            else move_delta(ba.move_cost, ba.move_base, i, j, na, nb)
        )
        di, dj = ba.hard_demand[i], ba.hard_demand[j]
        dov = swap_overload_delta(
            ba.avail[na], ba.avail[nb], used[bidx, na], used[bidx, nb], di, dj
        )
        return na, nb, dnet, dmove, dov, dj - di

    @staticmethod
    def _commit(P, used, bidx, i, j, na, nb, ddem, accept) -> None:
        P[bidx, i] = torch.where(accept, nb, na)
        P[bidx, j] = torch.where(accept, na, nb)
        du = torch.where(accept[:, None], ddem, 0.0)
        used[bidx, na] += du
        used[bidx, nb] -= du

    def _run_netcost(self, P0, ii, jj, thresh) -> torch.Tensor:
        ba = self.ba
        P = P0.clone()
        used = ba.used(P0)
        bidx = torch.arange(P.shape[0], device=P.device)
        for s in range(ii.shape[0]):
            i, j = ii[s], jj[s]
            na, nb, dnet, dmove, dov, ddem = self._swap_terms(P, used, bidx, i, j)
            # The reference's order: the penalized overload first, then the
            # migration term (1e6 × overload may round, so order matters).
            delta = dnet + OVERLOAD_PENALTY * dov
            if dmove is not None:
                delta = delta + dmove
            accept = (na != nb) & (delta <= thresh[s])
            self._commit(P, used, bidx, i, j, na, nb, ddem, accept)
        return P

    def _run_tp(self, P0, ii, jj, thresh, tm: ThroughputModel) -> torch.Tensor:
        ba = self.ba
        P = P0.clone()
        used = ba.used(P0)
        B = P.shape[0]
        bidx = torch.arange(B, device=P.device)
        cpu_load, mem_used, egress, ingress, rack_up, ack_num = aggregates(ba, tm, P)
        nic_cap, rack_cap = tm.nic_cap, tm.rack_cap
        tp = proxy_from_state(
            cpu_load, mem_used, egress, ingress, rack_up, ack_num, tm,
            nic_cap=nic_cap, rack_cap=rack_cap,
        )
        for s in range(ii.shape[0]):
            i, j = ii[s], jj[s]
            na, nb, dnet, dmove, dov, ddem = self._swap_terms(P, used, bidx, i, j)
            if dmove is not None:
                dnet = dnet + dmove
            # Candidate throughput state (functional copies; committed only
            # where accepted).
            dc = tm.task_cpu[j] - tm.task_cpu[i]
            dm = tm.task_mem[j] - tm.task_mem[i]
            cl, mu = cpu_load.clone(), mem_used.clone()
            cl[bidx, na] += dc
            cl[bidx, nb] -= dc
            mu[bidx, na] += dm
            mu[bidx, nb] -= dm
            (ei, ev, ii2, iv, ri, rv, ci, cv) = swap_state_terms(
                P, bidx, i, j, na, nb,
                ba.adj, tm.adj_bytes, tm.adj_src, tm.adj_comp, tm.adj_lat,
                tm.rack_of,
            )
            eg = egress.scatter_add(1, ei, ev)
            ing = ingress.scatter_add(1, ii2, iv)
            rk = rack_up.scatter_add(1, ri, rv)
            an = ack_num.scatter_add(1, ci, cv)
            lam = hard_lambda(
                cl, mu, eg, ing, rk,
                tm.cpu_cap, tm.mem_cap, nic_cap, rack_cap,
                tm.thrash_factor, tm.source_bound,
            )
            tp_new = torch.minimum(lam, ack_lambda(an, tm.den_flow, tm.ack)) * tm.sink_rate
            # Compare tp_new/tp directly, never tp_new - tp: a subtract after
            # the multiply is what an FMA-contracting compiler would fuse.
            accept = (na != nb) & (
                (dov < 0.0)
                | (
                    (dov == 0.0)
                    & ((tp_new > tp) | ((tp_new == tp) & (dnet <= thresh[s])))
                )
            )
            self._commit(P, used, bidx, i, j, na, nb, ddem, accept)
            w = accept[:, None]
            cpu_load = torch.where(w, cl, cpu_load)
            mem_used = torch.where(w, mu, mem_used)
            egress = torch.where(w, eg, egress)
            ingress = torch.where(w, ing, ingress)
            rack_up = torch.where(w, rk, rack_up)
            ack_num = torch.where(w, an, ack_num)
            tp = torch.where(accept, tp_new, tp)
        return P
