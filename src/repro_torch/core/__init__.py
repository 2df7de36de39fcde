# The paper's primary contribution, R-Storm resource-aware scheduling
# (Alg 1-4), and the batched placement search, in PyTorch.  Importing
# registers "rstorm" and "rstorm-search" in this package's own registry.
from .resources import (
    BANDWIDTH,
    CPU,
    MEMORY,
    ResourceVector,
    demand,
    weighted_distance,
)
from .topology import Component, Task, Topology
from .cluster import Cluster, Node, NodeSpec, emulab_cluster, emulab_cluster_24
from .traversal import bfs_topology_traversal, task_selection
from .node_selection import NodeSelector
from .engine import ArenaSelector, PlacementArena
from .assignment import Assignment
from .schedulers import RStormScheduler, Scheduler
from .registry import (
    REGISTRY,
    SCHEDULERS,
    KwargField,
    SchedulerEntry,
    get_scheduler,
    register_scheduler,
    scheduler_names,
    validate_scheduler_kwargs,
)
from .search import (
    BatchAnnealer,
    BatchArena,
    SearchScheduler,
    ThroughputModel,
    compile_throughput,
    evaluate_batch,
    throughput_batch,
)

__all__ = [
    "BANDWIDTH",
    "CPU",
    "MEMORY",
    "ResourceVector",
    "demand",
    "weighted_distance",
    "Component",
    "Task",
    "Topology",
    "Cluster",
    "Node",
    "NodeSpec",
    "emulab_cluster",
    "emulab_cluster_24",
    "bfs_topology_traversal",
    "task_selection",
    "NodeSelector",
    "ArenaSelector",
    "PlacementArena",
    "BatchAnnealer",
    "BatchArena",
    "SearchScheduler",
    "ThroughputModel",
    "compile_throughput",
    "evaluate_batch",
    "throughput_batch",
    "Assignment",
    "Scheduler",
    "RStormScheduler",
    "REGISTRY",
    "SCHEDULERS",
    "KwargField",
    "SchedulerEntry",
    "register_scheduler",
    "scheduler_names",
    "validate_scheduler_kwargs",
    "get_scheduler",
]
