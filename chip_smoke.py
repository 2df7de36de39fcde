"""Drive the PyTorch/CUDA port of the placement search on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

1. device: the card's name and power limit (nvidia-smi), then the time to
   build ``src/repro_torch/csrc/fused_score.cu`` with nvcc;
2. kernel: the CUDA ``fused_score`` against its plain torch version on the
   card, ``torch.equal`` on all four outputs, with and without a throughput
   model — the 1000-task / 256-node flagship case at 1024 candidates and in
   one 10,240-candidate call, every §6 micro and Yahoo topology on the
   Emulab cluster at 256 candidates, and the edge cases (no task edges,
   B=1, B=1027, a dead node, migration costs) — and the kernel's and the
   plain version's times at the shape the main path gives the kernel;
3. main path: ``rstorm-search`` on the flagship case through
   ``get_scheduler(...).schedule``, once per objective (netcost 64 chains ×
   5000 steps, throughput 1024 chains × 200 steps), holding the
   never-worse rule and hard feasibility, and counting kernel launches;
4. card against CPU: the same schedules with ``device="cpu"`` and
   ``device="cuda"`` give identical placements on the §6 suite (16 chains ×
   150 steps) and on the flagship case (64 chains × 200 steps).

The second-to-last lines are the card's nvidia-smi line and a JSON object
with the kernel's numbers; the last line is the device contract line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 (non-tensor) 34 TFLOP/s,
#: a rate that counts each fused multiply-add as two operations. The kernel is
#: built with -fmad=false and issues separate fp64 adds, multiplies and
#: compares, one per FP64 unit per clock, so its peak is half that: 17e12 ops/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_OPS_PER_S = 34e12 / 2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def chain_topology(core, components, parallelism, mem=128.0, cpu=10.0):
    """The flagship overhead case's linear chain (reference test recipe)."""
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


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, warmed)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as P
    from repro_torch import build
    from repro_torch.core.search.kernels import fused_inputs, fused_score, fused_score_plain
    from repro_torch.core.search.throughput import compile_throughput
    from repro_torch.stream import Simulator
    from repro_torch.stream import topologies as T

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"# device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build("fused_score")
    build_s = time.perf_counter() - t0
    print(f"# build: {lib_path.name} in {build_s:.2f} s")
    print(lib_path.with_suffix(".log").read_text().strip())

    # -- cases ------------------------------------------------------------------
    def compile_case(topology, cluster):
        arena = P.PlacementArena(cluster, topology)
        avail0 = arena.snapshot()
        a = P.Assignment(topology_id=topology.id)
        P.get_scheduler("rstorm")._place_on_arena(arena, topology, a)
        ba = P.BatchArena.from_arena(arena, topology, dict(a.placements), avail0=avail0)
        return ba, compile_throughput(ba, topology, cluster)

    def flagship():
        return chain_topology(P, 25, 40), P.Cluster.homogeneous(
            racks=8, nodes_per_rack=32, memory_mb=65536.0, cpu=6400.0
        )

    def random_batch(ba, n, seed, pool=None):
        rng = np.random.Generator(np.random.Philox(seed))
        pool = np.flatnonzero(ba.alive) if pool is None else pool
        return torch.as_tensor(pool[rng.integers(0, pool.size, size=(n, ba.n_tasks))], device=dev)

    # -- 2. kernel against its plain version ------------------------------------
    max_err = 0.0
    n_checked = 0

    def hold(label, ba, tm, Pb):
        nonlocal max_err, n_checked
        bad = ba.to(dev)
        tmd = tm.to(dev) if tm is not None else None
        got = fused_score(fused_inputs(bad, tmd), Pb)
        # The plain version materializes (B, E) intermediates: 1024 rows at
        # a time (rows are scored independently).
        parts = [fused_score_plain(bad, Pb[lo:lo + 1024], tmd) for lo in range(0, Pb.shape[0], 1024)]
        want = [None if p[0] is None else torch.cat(p) for p in zip(*parts)]
        torch.cuda.synchronize()
        for name, g, w in zip(("net", "violation", "dead", "throughput"), got, want):
            if w is None:
                check(g is None, f"{label}: {name} returned without a model")
                continue
            check(g.shape == w.shape and g.dtype == w.dtype, f"{label}: {name} shape/dtype")
            if not torch.equal(g, w):
                diff = torch.where(g == w, 0.0, (g.double() - w.double()).abs())
                max_err = max(max_err, float(diff.max()))
                fail(f"{label}: kernel {name} differs from the plain version "
                     f"(max abs {float(diff.max())!r})")
        n_checked += 1

    fl_topo, fl_cluster = flagship()
    fl_ba, fl_tm = compile_case(fl_topo, fl_cluster)
    for tm in (fl_tm, None):
        hold(f"flagship B=1024 tm={tm is not None}", fl_ba, tm, random_batch(fl_ba, 1024, 1))
    hold("flagship B=10240", fl_ba, fl_tm, random_batch(fl_ba, 10_240, 2))
    suite = {**{f"{k}_net": (lambda f=f: f(True)) for k, f in T.ALL_MICRO.items()},
             **{f"{k}_cpu": (lambda f=f: f(False)) for k, f in T.ALL_MICRO.items()},
             **T.ALL_YAHOO}
    for name, make in suite.items():
        ba, tm = compile_case(make(), P.emulab_cluster())
        for with_tm in (tm, None):
            hold(f"{name} B=256 tm={with_tm is not None}", ba, with_tm, random_batch(ba, 256, 3))
    solo = P.Topology("solo")
    solo.add_component(P.Component("s", is_spout=True, parallelism=4))
    solo_ba, solo_tm = compile_case(solo, P.emulab_cluster())
    check(solo_ba.edges.shape[0] == 0, "solo case has edges")
    hold("E=0", solo_ba, solo_tm, random_batch(solo_ba, 64, 4))
    pl_ba, pl_tm = compile_case(T.pageload(), P.emulab_cluster())
    hold("B=1", pl_ba, pl_tm, random_batch(pl_ba, 1, 5))
    hold("B=1027", pl_ba, pl_tm, random_batch(pl_ba, 1027, 6))
    crippled = P.emulab_cluster()
    crippled.fail_node(sorted(crippled.nodes)[0])
    dead_ba, dead_tm = compile_case(T.linear(True), crippled)
    check(int((~dead_ba.alive).sum()) == 1, "dead-node case has no dead node")
    dead_batch = random_batch(dead_ba, 128, 7, pool=np.arange(dead_ba.n_nodes))
    hold("dead node", dead_ba, dead_tm, dead_batch)
    rng = np.random.Generator(np.random.Philox(8))
    pl_ba.move_base = rng.integers(0, pl_ba.n_nodes, size=pl_ba.n_tasks).astype(np.intp)
    pl_ba.move_cost = rng.integers(1, 8, size=pl_ba.n_tasks).astype(np.float64) * 0.25
    hold("move arrays", pl_ba, pl_tm, random_batch(pl_ba, 256, 9))
    print(f"# kernel == plain (torch.equal, all outputs) in {n_checked} cases")

    # Timing at the main path's shape: the throughput search scores its
    # chains in chunks of 256 on the flagship case.
    fl_bad, fl_tmd = fl_ba.to(dev), fl_tm.to(dev)
    inputs = fused_inputs(fl_bad, fl_tmd)
    timing = {}
    for B in (256, 1024, 10_240):
        Pb = random_batch(fl_ba, B, 10 + B)
        kernel = time_ms(lambda: fused_score(inputs, Pb), 20 if B <= 1024 else 3)
        # The plain version's (B, E) intermediates at B=10,240 would take
        # tens of GB; it is timed at the two smaller shapes only.
        plain = time_ms(lambda: fused_score_plain(fl_bad, Pb, fl_tmd), 5) if B <= 1024 else None
        timing[B] = (kernel, plain)
        print(f"# fused_score flagship B={B}: kernel {kernel!r} ms, plain {plain!r} ms")
    Pm = random_batch(fl_ba, 256, 266)  # the timed B=256 batch
    kernel_ms, plain_ms = timing[256]
    bytes_moved = Pm.numel() * 4 + sum(t.numel() * t.element_size() for t in inputs.tables.values())
    bytes_moved += 256 * (8 + 8 + 8 + 8)
    ops = fused_score_ops(fl_bad, fl_tmd, Pm)
    bound_bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = ops / PEAK_FP64_OPS_PER_S * 1e3
    print(f"# bound at B=256: {bytes_moved} B -> {bound_bytes_ms!r} ms, {ops} fp64 ops -> {bound_ops_ms!r} ms")

    # -- 3. main path -------------------------------------------------------------
    fused_score.launches = 0
    greedy = P.get_scheduler("rstorm").schedule(fl_topo, fl_cluster, commit=False)
    fl_cluster.reset()
    greedy_net = greedy.network_cost(fl_topo, fl_cluster)
    sim = Simulator(fl_cluster)
    greedy_tp = sim.run(fl_topo, greedy).sink_throughput
    runs = {}
    for objective, chains, steps in (("netcost", 64, 5000), ("throughput", 1024, 200)):
        before = fused_score.launches
        sched = P.get_scheduler(
            "rstorm-search", n_chains=chains, steps=steps, seed=0,
            objective=objective, device="cuda",
        )
        t0 = time.perf_counter()
        out = sched.schedule(fl_topo, fl_cluster, commit=False)
        wall = time.perf_counter() - t0
        net = out.network_cost(fl_topo, fl_cluster)
        tp = sim.run(fl_topo, out).sink_throughput
        check(out.hard_violations(fl_topo, fl_cluster) == [], f"{objective}: hard violations")
        check(sorted(out.placements) == sorted(greedy.placements), f"{objective}: task set changed")
        if objective == "netcost":
            check(net <= greedy_net, f"netcost search worse than greedy ({net} > {greedy_net})")
        else:
            check(tp >= greedy_tp, f"throughput search worse than greedy in simulation ({tp} < {greedy_tp})")
        runs[objective] = dict(
            chains=chains, steps=steps, netcost=net, greedy_netcost=greedy_net,
            sim_sink_tp=tp, greedy_sim_sink_tp=greedy_tp, wall_s=wall,
            phase_s=sched.last_phase_s, launches=fused_score.launches - before,
        )
        print(f"# main path {objective}: {json.dumps(runs[objective])}")
    main_launches = fused_score.launches
    check(main_launches > 0, "the main path never launched fused_score")
    for objective, run in runs.items():
        check(run["launches"] > 0, f"{objective} search never launched fused_score")

    # -- 4. card against CPU -------------------------------------------------------
    def placements(topology, cluster, device, **kw):
        cluster.reset()
        return P.get_scheduler("rstorm-search", device=device, **kw).schedule(
            topology, cluster, commit=False
        ).placements

    n_same = 0
    for name, make in suite.items():
        for objective in ("netcost", "throughput"):
            kw = dict(n_chains=16, steps=150, seed=1, objective=objective)
            topology, cluster = make(), P.emulab_cluster()
            a = placements(topology, cluster, "cpu", **kw)
            b = placements(topology, cluster, "cuda", **kw)
            check(a == b, f"{name}/{objective}: cuda placements differ from cpu")
            n_same += 1
    for objective in ("netcost", "throughput"):
        kw = dict(n_chains=64, steps=200, seed=2, objective=objective)
        a = placements(fl_topo, fl_cluster, "cpu", **kw)
        b = placements(fl_topo, fl_cluster, "cuda", **kw)
        check(a == b, f"flagship/{objective}: cuda placements differ from cpu")
        n_same += 1
    print(f"# cuda placements == cpu placements in {n_same} schedules")

    kernels = {"kernels": [{
        "name": "fused_score",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_score.cu",
        "replaces": "src/repro/core/search/kernels/fused_score.py:63",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
    }]}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


def fused_score_ops(ba, tm, P) -> int:
    """fp64 additions, multiplications, divisions and comparisons that
    ``fused_score`` needs for this batch (counted from the data: skipped
    zero contributions and locally routed edges do no work)."""
    from repro_torch.core.search.throughput import segment_sum

    B, T = P.shape
    N, Dh, E = ba.n_nodes, ba.avail.shape[1], ba.edges.shape[0]
    R, K = max(tm.n_racks, 1), tm.n_combos
    src_n, dst_n = P[:, ba.edges[:, 0]], P[:, ba.edges[:, 1]]
    colo = src_n == dst_n
    L = segment_sum(tm.pair_key.expand(src_n.shape), colo.double(), K)
    routed = tm.edge_local & (L[:, tm.pair_key] > 0.0)
    cross_rack = tm.rack_of[src_n] != tm.rack_of[dst_n]
    ops = B * T * (Dh + 2)                       # capacity, cpu and memory scatters
    ops += int((P != ba.move_arrays()[0]).sum())  # migration term
    ops += B * E                                 # net gather: one add per edge
    ops += int(colo.sum())                       # colocation counts
    ops += 2 * int((~colo & ~routed).sum())      # egress and ingress
    ops += int((cross_rack & ~routed).sum())     # rack uplinks
    ops += int((~routed).sum())                  # hop latencies
    ops += int((L > 0.0).sum())                  # locally routed combos
    ops += B * N * (2 * Dh + 10) + B * R * 2     # overshoot, thrash, 3 ratios, minima
    ops += B * 3 * (max(tm.ack.n_comp_edges, 1) + len(tm.ack.svc))  # ack recursion
    return ops


if __name__ == "__main__":
    main()
