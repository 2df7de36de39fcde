"""Shared cases for the PyTorch port's parity tests (``test_torch_*.py``).

Each case is built twice from the same recipe: once with the JAX
package's own builders (``repro``), once with the port's copies
(``repro_torch``).  The port is then held to the reference's
``backend="numpy"`` path — the oracle the reference pins bit-identical to
its jax and Pallas paths — with exact equality: every search input sits on
a dyadic grid, so a tolerance could only hide a bug.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import repro.core as R
import repro_torch.core as P
from repro.core.search.throughput import compile_throughput as ref_compile_throughput
from repro.stream import topologies as RT
from repro_torch.core.search.throughput import compile_throughput as port_compile_throughput
from repro_torch.stream import topologies as PT

#: The §6 micro and Yahoo suite: (name, recipe taking a topologies module).
SUITE = [
    ("linear_net", lambda T: T.linear(True)),
    ("diamond_net", lambda T: T.diamond(True)),
    ("star_net", lambda T: T.star(True)),
    ("linear_cpu", lambda T: T.linear(False)),
    ("diamond_cpu", lambda T: T.diamond(False)),
    ("star_cpu", lambda T: T.star(False)),
    ("pageload", lambda T: T.pageload()),
    ("processing", lambda T: T.processing()),
]
SUITE_IDS = [name for name, _ in SUITE]
RECIPES = dict(SUITE)


def chain_topology(core, components=5, parallelism=4, mem=128.0, cpu=10.0):
    """The reference tests' chain topology, built with ``core``'s classes."""
    t = core.Topology(f"chain{components}x{parallelism}")
    prev = None
    for i in range(components):
        c = core.Component(f"c{i}", is_spout=(i == 0), parallelism=parallelism)
        c.set_memory_load(mem).set_cpu_load(cpu)
        t.add_component(c)
        if prev:
            t.add_edge(prev, c.id)
        prev = c.id
    return t


def single_component(core):
    """One spout, four tasks: no task edges (E == 0)."""
    t = core.Topology("solo")
    t.add_component(core.Component("s", is_spout=True, parallelism=4))
    return t


def flagship_cluster(core):
    """The 1000-task / 256-node overhead case's cluster."""
    return core.Cluster.homogeneous(
        racks=8, nodes_per_rack=32, memory_mb=65536.0, cpu=6400.0
    )


def topology_of(core, name):
    """A named case built with ``core`` (``repro.core`` or ``repro_torch.core``)."""
    topologies = RT if core is R else PT
    if name in RECIPES:
        return RECIPES[name](topologies)
    if name == "flagship":
        return chain_topology(core, 25, 40)
    if name == "solo":
        return single_component(core)
    raise KeyError(name)


def cluster_of(core, name):
    return flagship_cluster(core) if name == "flagship" else core.emulab_cluster()


def compile_case(core, name, with_tm=True):
    """(topology, cluster, greedy assignment, numpy BatchArena, model) on
    ``core``'s side, the way the reference tests' ``compile_case`` builds it."""
    topology, cluster = topology_of(core, name), cluster_of(core, name)
    arena = core.PlacementArena(cluster, topology)
    avail0 = arena.snapshot()
    assignment = core.Assignment(topology_id=topology.id)
    core.get_scheduler("rstorm")._place_on_arena(arena, topology, assignment)
    ba = core.BatchArena.from_arena(
        arena, topology, dict(assignment.placements), avail0=avail0
    )
    compile_tp = ref_compile_throughput if core is R else port_compile_throughput
    tm = compile_tp(ba, topology, cluster) if with_tm else None
    return topology, cluster, assignment, ba, tm


def random_batch(ba, n, seed=0):
    """Random alive placements from a seed (numpy Philox), as in the
    reference tests."""
    rng = np.random.Generator(np.random.Philox(seed))
    pool = np.flatnonzero(ba.alive)
    return pool[rng.integers(0, pool.size, size=(n, ba.n_tasks))]


def with_moves(ba, seed):
    """The arena with reconfiguration move arrays (pre-move nodes and
    dyadic per-task costs), as ``ReconfigEngine`` attaches them."""
    rng = np.random.Generator(np.random.Philox(seed))
    mb = rng.integers(0, ba.n_nodes, size=ba.n_tasks).astype(np.intp)
    mc = rng.integers(0, 8, size=ba.n_tasks).astype(np.float64) * 0.25
    return dataclasses.replace(ba, move_base=mb, move_cost=mc)


def without_hard_dims(ba):
    """The arena with no hard columns (Dh == 0)."""
    return dataclasses.replace(
        ba,
        hard_dims=[],
        avail=np.zeros((ba.n_nodes, 0)),
        hard_demand=np.zeros((ba.n_tasks, 0)),
    )


# -- LM substrate ------------------------------------------------------------------
def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in f32 — the reference's kernel-test
    measure (``tests/test_kernels.py::assert_close``)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(float(np.max(np.abs(ref))), 1e-6))


def lm_pair(cfg, seed=0):
    """The reference model with its seeded parameters, and the port's model
    on the CPU carrying the same parameters (``params_from_jax``)."""
    import jax

    from repro.models.lm import Model as RefModel
    from repro_torch.models import Model as PortModel, params_from_jax

    ref = RefModel(cfg)
    params = ref.init_params(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = params_from_jax(PortModel(cfg, device="cpu"), tree)
    return ref, params, port
