"""BatchArena — the PlacementArena compiled for batched candidate search.

Where the arena answers "which node next for *this* task" (one greedy
descent), the BatchArena holds everything needed to score *complete*
placements wholesale: a candidate batch is an int array ``(B, T)`` of node
indices, and feasibility + network cost for all B candidates is one
vectorized reduction (:mod:`repro.core.search.objective`).

Compiled once per search from an arena:

* ``net``          — the arena's N×N rack net-distance matrix (shared, not
  copied);
* ``avail``        — N×Dh availability on the hard columns *before* this
  topology's tasks are placed (the capacity budget a candidate must fit);
* ``hard_demand``  — T×Dh per-task demand on those columns (the
  hard-constraint column mask applied at compile time);
* ``alive``        — N bool mask (dead-node hits make a candidate
  infeasible);
* ``edges``        — E×2 task-index pairs over the placed tasks (inter-node
  edge traffic × distance is the objective's cost term);
* ``adj``/``adj_mask`` — T×max_deg padded adjacency for O(degree)
  batched swap deltas (same delta implementation as ``SwapAnnealer``).

Task order is ``sorted(placements)`` — the same canonical order the
sequential annealer uses, so seeds and results translate losslessly between
the two engines.

The compile is numpy, as in the reference.  ``to(device)`` uploads every
array once (float64 stays float64, index arrays become int64); the scoring
and annealing functions take the uploaded arena.  ``from_numpy`` builds one
from a dict of plain arrays (``dataclasses.asdict`` of the reference's
arena), which lets the tests score the reference's own compiled arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..engine.arena import PlacementArena
from ..topology import Topology
from .backend import DeviceLike, as_tensor, resolve_device

#: Fields holding arrays (uploaded by ``to``); the rest are host metadata.
_ARRAY_FIELDS = (
    "net", "avail", "hard_demand", "alive", "edges", "adj", "adj_mask",
    "rack_of", "move_base", "move_cost",
)


@dataclasses.dataclass
class BatchArena:
    """Dense batch-evaluation view over one (topology, cluster) pair.

    Arrays are numpy after ``from_arena`` and torch tensors on one device
    after ``to(device)``.
    """

    node_ids: List[str]
    tids: List[str]
    hard_dims: List[str]
    net: np.ndarray  # (N, N) float64
    avail: np.ndarray  # (N, Dh) float64, pre-placement hard-column budget
    hard_demand: np.ndarray  # (T, Dh) float64
    alive: np.ndarray  # (N,) bool
    edges: np.ndarray  # (E, 2) intp task-index pairs
    adj: np.ndarray  # (T, max_deg) intp, -1 padded
    adj_mask: np.ndarray  # (T, max_deg) bool
    # Rack topology (throughput-proxy link flows): rack index per node.
    rack_of: Optional[np.ndarray] = None  # (N,) intp
    n_racks: int = 0
    # Migration soft-cost (reconfiguration searches): a per-task penalty
    # added to ``net`` for every task placed away from its pre-rebalance
    # node, so the search trades netcost/throughput gains against live-
    # cluster disruption.  None ⇔ no move term (from-scratch scheduling):
    # the plain evaluator skips the term and the kernel receives zero
    # arrays, whose +0.0 contribution is bitwise inert on the non-negative
    # net sums — scores stay golden-equal to pre-move arenas.
    # Costs must be dyadic-grid multiples (the engine quantizes them) so
    # the summed term is exact in any accumulation order.
    move_base: Optional[np.ndarray] = None  # (T,) intp pre-move node index
    move_cost: Optional[np.ndarray] = None  # (T,) float64 per-task penalty

    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def n_tasks(self) -> int:
        return len(self.tids)

    @classmethod
    def from_arena(
        cls,
        arena: PlacementArena,
        topology: Topology,
        placements: Dict[str, str],
        avail0: Optional[np.ndarray] = None,
    ) -> "BatchArena":
        """Compile the batch view for the tasks in ``placements``.

        ``avail0`` is the arena availability snapshot taken *before* those
        tasks were assigned (``arena.snapshot()``); defaults to the arena's
        current ledger for callers compiling against an untouched arena.
        """
        tids = sorted(placements)
        tindex = {tid: i for i, tid in enumerate(tids)}
        avail_all = arena.avail if avail0 is None else avail0

        # Hard columns: dims any placed task declares hard.  Soft columns
        # never constrain feasibility (they may legally go negative), so
        # they are dropped at compile time.
        demands = {t.id: topology.demand_of(t) for t in topology.all_tasks()}
        hard_dims = sorted(
            {dim for tid in tids for dim in demands[tid].hard}
        )
        hard_cols = np.array([arena.dim_col[d] for d in hard_dims], dtype=np.intp)
        hard_demand = np.zeros((len(tids), len(hard_dims)), dtype=np.float64)
        for tid in tids:
            rv = demands[tid]
            for j, dim in enumerate(hard_dims):
                if dim in rv.hard:
                    hard_demand[tindex[tid], j] = rv[dim]
        avail = (
            avail_all[:, hard_cols].astype(np.float64, copy=True)
            if hard_cols.size
            else np.zeros((len(arena.node_ids), 0), dtype=np.float64)
        )

        # Directed task edges over placed tasks + padded adjacency.
        adj_lists: List[List[int]] = [[] for _ in tids]
        edge_pairs: List[List[int]] = []
        for src, dst in topology.task_edges():
            a, b = tindex.get(src.id), tindex.get(dst.id)
            if a is None or b is None:
                continue
            edge_pairs.append([a, b])
            adj_lists[a].append(b)
            adj_lists[b].append(a)
        edges = (
            np.array(edge_pairs, dtype=np.intp)
            if edge_pairs
            else np.zeros((0, 2), dtype=np.intp)
        )
        max_deg = max((len(x) for x in adj_lists), default=0)
        adj = np.full((len(tids), max(max_deg, 1)), -1, dtype=np.intp)
        for i, nbrs in enumerate(adj_lists):
            adj[i, : len(nbrs)] = nbrs
        adj_mask = adj >= 0

        return cls(
            node_ids=list(arena.node_ids),
            tids=tids,
            hard_dims=hard_dims,
            net=arena.net,
            avail=avail,
            hard_demand=hard_demand,
            alive=arena.alive.copy(),
            edges=edges,
            adj=adj,
            adj_mask=adj_mask,
            rack_of=arena.rack_of.copy(),
            n_racks=len(arena.rack_ids),
        )

    @classmethod
    def from_numpy(cls, fields: Dict, device: DeviceLike = None) -> "BatchArena":
        """An uploaded arena from plain numpy arrays and scalars (e.g.
        ``dataclasses.asdict`` of a reference ``BatchArena``)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names}).to(device)

    def to(self, device: DeviceLike = None) -> "BatchArena":
        """A copy with every array uploaded to ``device`` (``None`` = the card)."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            **{
                name: as_tensor(getattr(self, name), dev)
                for name in _ARRAY_FIELDS
                if getattr(self, name) is not None
            },
        )

    @property
    def device(self) -> torch.device:
        if not isinstance(self.net, torch.Tensor):
            raise TypeError("BatchArena is not uploaded; call .to(device) first")
        return self.net.device

    def move_arrays(self) -> "tuple[torch.Tensor, torch.Tensor]":
        """``(move_base, move_cost)`` with zero-cost defaults — the dense
        form the fused kernel always consumes (cost 0.0 ⇔ the move term
        adds +0.0, which is bitwise inert on the non-negative net sums)."""
        if self.move_cost is None:
            T = self.n_tasks
            return (
                torch.zeros(T, dtype=torch.int64, device=self.device),
                torch.zeros(T, dtype=torch.float64, device=self.device),
            )
        return self.move_base, self.move_cost

    # -- placement codecs ------------------------------------------------------
    def encode(self, placements: Dict[str, str]) -> np.ndarray:
        """task→node-id dict (over exactly ``self.tids``) → (T,) index row."""
        index = {nid: i for i, nid in enumerate(self.node_ids)}
        return np.array([index[placements[tid]] for tid in self.tids], dtype=np.intp)

    def decode(self, row: np.ndarray) -> Dict[str, str]:
        """(T,) node-index row → task→node-id dict."""
        return {tid: self.node_ids[int(row[i])] for i, tid in enumerate(self.tids)}

    def used(self, placements: torch.Tensor) -> torch.Tensor:
        """Per-node hard-column usage for an uploaded batch ``(B, T)`` →
        ``(B, N, Dh)`` (dyadic demands: the scatter order cannot change a bit)."""
        P = placements if placements.dim() == 2 else placements[None, :]
        B, T = P.shape
        N, Dh = self.n_nodes, len(self.hard_dims)
        flat = (
            torch.arange(B, device=P.device, dtype=torch.int64)[:, None] * N + P
        ).reshape(-1)
        out = torch.zeros(B * N, Dh, dtype=torch.float64, device=P.device)
        out.index_add_(0, flat, self.hard_demand.repeat(B, 1))
        return out.reshape(B, N, Dh)
