"""End-to-end parity of the port's schedulers against the reference.

``repro_torch.core.get_scheduler("rstorm" | "rstorm-search", device="cpu")``
must return the reference's placements (``backend="numpy"`` for the
search) for both seeding modes and both objectives across the §6 suite,
including the near-full cluster where the search recovers a task greedy
R-Storm stranded.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from torch_cases import SUITE_IDS, cluster_of, topology_of  # noqa: E402


def schedule_both(name_or_case, scheduler, ref_kw, port_kw):
    if isinstance(name_or_case, str):
        make = lambda core: (topology_of(core, name_or_case), cluster_of(core, name_or_case))  # noqa: E731
    else:
        make = name_or_case
    rt, rc = make(R)
    pt, pc = make(P)
    ref = R.get_scheduler(scheduler, **ref_kw).schedule(rt, rc, commit=False)
    out = P.get_scheduler(scheduler, **port_kw).schedule(pt, pc, commit=False)
    return (rt, rc, ref), (pt, pc, out)


@pytest.mark.parametrize("name", SUITE_IDS)
def test_rstorm_placements_equal_reference(name):
    (_, _, ref), (_, _, out) = schedule_both(name, "rstorm", {}, {})
    assert out.placements == ref.placements
    assert out.unassigned == ref.unassigned
    assert out.scheduler_name == "rstorm"


@pytest.mark.parametrize("objective", ["netcost", "throughput"])
@pytest.mark.parametrize("init", ["greedy", "random"])
@pytest.mark.parametrize("name", SUITE_IDS)
def test_search_placements_equal_reference(name, init, objective):
    kw = dict(n_chains=16, steps=150, seed=3, init=init, objective=objective)
    (rt, rc, ref), (pt, pc, out) = schedule_both(
        name, "rstorm-search", {**kw, "backend": "numpy"}, {**kw, "device": "cpu"}
    )
    assert out.placements == ref.placements
    assert out.unassigned == ref.unassigned
    assert out.network_cost(pt, pc) == ref.network_cost(rt, rc)
    assert out.hard_violations(pt, pc) == []


def recovery_case(core):
    """The reference tests' near-full two-node cluster where greedy's spread
    strands the big sink task but a consolidated rearrangement fits it."""
    t = core.Topology("recov")
    prev = None
    for k in range(3):
        comp = core.Component(f"c{k}", is_spout=(k == 0), parallelism=1)
        comp.set_memory_load(500.0).set_cpu_load(60.0)
        t.add_component(comp)
        if prev:
            t.add_edge(prev, comp.id)
        prev = comp.id
    x = core.Component("x", parallelism=1)
    x.set_memory_load(1100.0).set_cpu_load(10.0)
    t.add_component(x)
    t.add_edge(prev, "x")
    cl = core.Cluster([core.NodeSpec(f"n{i}", "rack0", 100.0, 1500.0) for i in range(2)])
    return t, cl


@pytest.mark.parametrize("objective", ["netcost", "throughput"])
def test_search_recovers_task_greedy_stranded_like_reference(objective):
    (_, _, greedy), _ = schedule_both(recovery_case, "rstorm", {}, {})
    assert greedy.unassigned == ["recov/x[0]"]  # the setup's premise
    kw = dict(n_chains=12, steps=150, seed=0, init="random", objective=objective)
    (rt, rc, ref), (pt, pc, out) = schedule_both(
        recovery_case, "rstorm-search", {**kw, "backend": "numpy"}, {**kw, "device": "cpu"}
    )
    assert out.placements == ref.placements
    assert out.unassigned == ref.unassigned
    if objective == "netcost":
        assert out.is_complete(pt)
    assert out.hard_violations(pt, pc) == []


def test_search_commit_and_budget_plan_match_reference():
    kw = dict(budget_s=0.1, seed=1)
    rt, rc = topology_of(R, "diamond_net"), cluster_of(R, "diamond_net")
    pt, pc = topology_of(P, "diamond_net"), cluster_of(P, "diamond_net")
    ref = R.get_scheduler("rstorm-search", backend="numpy", **kw).schedule(rt, rc)
    out = P.get_scheduler("rstorm-search", device="cpu", **kw).schedule(pt, pc)
    assert out.placements == ref.placements
    assert {n: sorted(map(str, node.assigned_tasks)) for n, node in pc.nodes.items()} == {
        n: sorted(map(str, node.assigned_tasks)) for n, node in rc.nodes.items()
    }
    assert {n: node.available.values for n, node in pc.nodes.items()} == {
        n: node.available.values for n, node in rc.nodes.items()
    }
    assert out.schedule_time_s > 0.0
