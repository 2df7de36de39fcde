"""Algorithm 2 — BFS topology traversal, and Algorithm 3 — task selection.

The BFS starts from the spouts ("the performance of spout(s) impacts the
performance of the whole topology", §4.1.1) and yields a partial ordering of
components in which adjacent components sit in close succession.  Task
selection then round-robins one task per component over that ordering until
every task is ordered — so tasks of adjacent components are scheduled as
close together (in time, hence by the greedy node selection in space) as
possible.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

from .topology import Component, Task, Topology


def bfs_topology_traversal(topology: Topology, roots: Optional[Sequence[str]] = None) -> List[str]:
    """Alg 2, generalized to multiple roots (all spouts enqueue first).

    Returns component ids in BFS order.  Neighbour expansion follows
    ``Topology.neighbors`` (downstream first, then upstream), which makes the
    traversal well-defined on DAGs with joins and on (the paper's claim of
    support for) cyclic topologies alike — visited-set bookkeeping terminates
    cycles.
    """
    if roots is None:
        roots = [c.id for c in topology.spouts]
    if not roots:
        return []
    queue: deque = deque()
    visited: List[str] = []
    seen = set()
    for root in roots:
        if root not in topology.components:
            raise KeyError(f"unknown root component {root!r}")
        if root not in seen:
            queue.append(root)
            seen.add(root)
            visited.append(root)
    while queue:
        com = queue.popleft()
        for nbr in topology.neighbors(com):
            if nbr not in seen:
                seen.add(nbr)
                visited.append(nbr)
                queue.append(nbr)
    # Isolated components (none in valid topologies, but keep total).
    for cid in topology.components:
        if cid not in seen:
            visited.append(cid)
    return visited


def task_selection(topology: Topology) -> List[Task]:
    """Alg 3 — interleave one task per component over the BFS ordering."""
    order = bfs_topology_traversal(topology)
    remaining: Dict[str, List[Task]] = {
        cid: list(topology.components[cid].tasks(topology.id)) for cid in order
    }
    task_ordering: List[Task] = []
    total = topology.task_count()
    while len(task_ordering) < total:
        progressed = False
        for cid in order:
            bucket = remaining[cid]
            if bucket:
                task_ordering.append(bucket.pop(0))
                progressed = True
        if not progressed:  # pragma: no cover - defensive
            break
    return task_ordering
