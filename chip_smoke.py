"""Drive the PyTorch/CUDA port on one CUDA card: the placement search, LM
serving on qwen3-0.6b, MoE serving on olmoe-1b-7b and hybrid (recurrent and
local attention) serving on recurrentgemma-9b.

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
   150 steps) and on the flagship case (64 chains × 200 steps);
5. LM kernel build: ``flash_attention.cu``, ``decode_attention.cu``,
   ``grouped_gemm.cu`` and ``rglru_scan.cu`` (started in the background with
   phase 1, one nvcc each), their build seconds and ptxas reports;
6. LM kernels against their plain versions on the card (relative max error
   ≤ 1e-4 in f32, ≤ 3e-2 in bf16): flash on four shapes under causal,
   bidirectional and window-256 masks, decode at B=8 / cache 4096 over five
   lengths (host and device lengths) and at G=3 / hd 64; both through the
   model-layout ops (strided views) at the shapes phases 7, 9 and 11 give
   them (recurrentgemma-9b: hd 256, one KV head, window 2048, also over
   4096 tokens); the grouped GEMM at olmoe-1b-7b's prefill and decode
   shapes, the reference sweep's shapes and ragged ones; the RG-LRU scan at
   recurrentgemma-9b's (4, 2048 and 2047, 4096) with zero and random h0,
   the reference sweep's shapes, S = 1 and odd D, in f32 and bf16.  Times
   of kernel, plain version and a PyTorch yardstick
   (``scaled_dot_product_attention``, ``torch.bmm``; never on the path; the
   scan has none) at the main paths' shapes, with the card's bound;
7. main path: qwen3-0.6b at full width and depth with seeded bf16 weights —
   ``prefill`` of 4 × 2048 tokens, ``extend_cache`` to 2112, 64 greedy
   ``decode_step``s, ``forward``, and ``ServingEngine(batch_slots=8,
   max_seq=512)`` serving 16 requests of 32 new tokens; 28 flash launches
   per forward and 28 decode launches per step; ``forward``'s last position
   against prefill of S - 1 + one decode step within 3e-2;
8. the same weights and prompts with the model's attention ops bound to
   the plain versions: prefill logits and 16 teacher-forced decode steps
   within 3e-2 of the kernel path;
9. main path: olmoe-1b-7b (64 experts, top-8) at full width and depth, as
   phase 7, with ``ServingEngine(batch_slots=8, max_seq=256)`` serving 8
   requests of 16 new tokens; 48 grouped-GEMM and 16 flash launches per
   forward, 48 grouped-GEMM and 16 decode launches per step; the check of
   ``forward`` against prefill + decode at the dropless capacity factor
   E / K;
10. olmoe-1b-7b with the model's attention ops and grouped GEMM bound to
   the plain versions, in bf16 (within 3e-2) and in f32 (prefill of
   4 × 256, 8 steps; the sequences routed alike, within 1e-4).  Token rows
   routed to another expert set at some layer are counted and printed, and
   the plain path is run again on the kernel path's experts, every row
   within the same tolerance;
11. main path: recurrentgemma-9b (26 RG-LRU and 12 local-attention layers,
   window 2048, one KV head of 256) at full width and depth, as phase 7,
   with ``ServingEngine(batch_slots=8, max_seq=256)`` serving 8 requests of
   16 new tokens; 26 scan and 12 flash launches per forward, 12 decode
   launches and no scan per step (a step's recurrence is plain arithmetic);
   the 64 decode steps wrap the local layers' 2048-row ring; ``forward``
   against prefill + decode held on an f32 copy of the model within 1e-4
   (``SERVED``: in bf16 the two paths round apart through 38 layers; that
   error is printed);
12. recurrentgemma-9b with the model's attention ops and scan bound to the
   plain versions: prefill logits of the main path's 4 × 2048 prompts and
   16 teacher-forced decode steps, held on an f32 copy of the model within
   1e-4 of the kernel path; the bf16 model's error is printed (``SERVED``).

Phases 7, 9 and 11 share one path (``serving_main_path``), and 8, 10 and
12 one comparison (``compare``).  The launch counters are set to 0 after
each model's warm-up; the ``launches`` of the kernels line are those of the
three main paths, without the forward-against-decode checks and the plain
paths.

Each phase prints its seconds.  The second-to-last lines are the card's
nvidia-smi line and a JSON object with the five kernels' numbers; the last
line is the device contract line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

#: NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 (non-tensor) 34 TFLOP/s,
#: a rate that counts each fused multiply-add as two operations. The kernel is
#: built with -fmad=false and issues separate fp64 adds, multiplies and
#: compares, one per FP64 unit per clock, so its peak is half that: 17e12 ops/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_OPS_PER_S = 34e12 / 2
#: Dense bf16 tensor-core rate and the f32 rate outside the tensor cores
#: (the same data sheet): the peaks for attention on bf16 and f32 inputs.
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

LM_KERNELS = ["flash_attention", "decode_attention", "grouped_gemm", "rglru_scan"]
#: Relative max error of a kernel against its plain version: the
#: reference's own ``tol_for`` (tests/test_kernels.py).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: (B, H, Kv, S, hd) of the flash checks: the main path's widths at S = 128
#: and 2048, an MQA case, and a ragged G = 3 case.
FLASH_CASES = [(1, 16, 8, 128, 128), (4, 16, 8, 2048, 128), (1, 4, 1, 100, 64), (1, 15, 5, 513, 64)]
FLASH_MASKS = [(True, None), (False, None), (True, 256)]
#: (B, H, Kv, S, hd, lengths) of the decode checks.
DECODE_CASES = [(8, 16, 8, 4096, 128, (1, 511, 512, 513, 4096)),
                (4, 15, 5, 1024, 64, (1, 333, 1024))]
#: The shapes phases 7 (qwen3-0.6b: H=16, Kv=8, hd=128), 9 (olmoe-1b-7b:
#: H=Kv=16, hd=128) and 11 (recurrentgemma-9b: H=16, Kv=1, hd=256, local
#: layers with window 2048) give the model-layout ops: flash (B, S, H, Kv,
#: hd, window) of prefill and of the prefill of S - 1 tokens, and for
#: recurrentgemma one case past its window; decode (B, cache, H, Kv, hd,
#: lengths) of the 64 decode steps (recurrentgemma: a 2048-row ring, full
#: from position 2047 on) and of the engine (qwen3: prompts of up to 128
#: tokens plus 32 new ones; olmoe and recurrentgemma: up to 64 plus 16).
FLASH_OP_CASES = [(4, 2048, 16, 8, 128, None), (4, 2047, 16, 8, 128, None),
                  (4, 2048, 16, 16, 128, None), (4, 2047, 16, 16, 128, None),
                  (4, 2048, 16, 1, 256, 2048), (4, 2047, 16, 1, 256, 2048), (1, 4096, 16, 1, 256, 2048)]
DECODE_OP_CASES = [(4, 2112, 16, 8, 128, (2049, 2080, 2112)), (8, 512, 16, 8, 128, (1, 17, 100, 160)),
                   (4, 2112, 16, 16, 128, (2049, 2080, 2112)), (8, 256, 16, 16, 128, (1, 17, 64, 80)),
                   (4, 2048, 16, 1, 256, (1, 1000, 2047, 2048)), (8, 256, 16, 1, 256, (1, 17, 64, 80))]
#: (E, C, D, F) of the grouped-GEMM checks: olmoe-1b-7b's prefill (4 × 2048
#: tokens, C = 1280) and decode (C = 8) shapes for wi/wu and for wd; the
#: reference sweep's shapes (tests/test_kernels.py); ragged ones.
GG_MAIN = {"prefill wi/wu": (64, 1280, 2048, 1024), "prefill wd": (64, 1280, 1024, 2048),
           "decode wi/wu": (64, 8, 2048, 1024), "decode wd": (64, 8, 1024, 2048)}
GG_CASES = (list(GG_MAIN.values())
            + [(e, c, d, f) for e in (1, 4, 8) for c in (128, 256) for d in (128, 256) for f in (128, 384)]
            + [(3, 24, 200, 72), (2, 7, 13, 5), (5, 1, 64, 33), (4, 8, 96, 40), (2, 130, 36, 129)])
#: (B, S, D) of the RG-LRU scan checks: recurrentgemma-9b's forward (4 ×
#: 2048 tokens) and forward check (2047); the reference sweep's shapes
#: (tests/test_kernels.py); one step; odd widths.
RGLRU_MAIN = (4, 2048, 4096)
RGLRU_CASES = ([RGLRU_MAIN, (4, 2047, 4096)]
               + [(b, s, d) for b in (1, 3) for s in (128, 256, 512) for d in (64, 128)]
               + [(2, 1, 4096), (1, 2047, 8), (3, 100, 37), (5, 129, 4097)])

#: The models phases 7-12 serve, with their main paths' engine runs:
#: phase, seed of the prompts (the requests' is the next), batch slots,
#: max_seq, requests, prompt lengths [lo, hi) and new tokens per request.
#: ``held_dtype``, where given, is the dtype of a copy of the model (same
#: seed) on which the two whole-model checks are held at that dtype's
#: tolerance: forward against prefill(S - 1) + one decode step, and the
#: kernel path against the plain path (the main path's prompts and fed
#: tokens); the bf16 model's errors are then printed, not held.  Else the
#: bf16 model holds both at 3e-2.  recurrentgemma-9b rounds its bf16
#: residual stream at each of 38 layers, and two correct bf16 paths drift
#: apart layer by layer: forward against prefill + decode ends about 0.037
#: apart with the plain versions as with the kernels, and so does the
#: kernel path from the plain path, while in f32 both agree to 2e-5
#: (on an NVIDIA H100; PERF.md, Findings).
SERVED = {
    "qwen3-0.6b": dict(phase=7, seed=7, slots=8, max_seq=512, requests=16, prompt_len=(16, 129), new_tokens=32),
    "olmoe-1b-7b": dict(phase=9, seed=9, slots=8, max_seq=256, requests=8, prompt_len=(16, 65), new_tokens=16),
    "recurrentgemma-9b": dict(phase=11, seed=11, slots=8, max_seq=256, requests=8, prompt_len=(16, 65),
                              new_tokens=16, held_dtype="float32"),
}


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


def phase_done(n: int, t0: float) -> float:
    now = time.perf_counter()
    print(f"# phase {n}: {now - t0:.2f} s", flush=True)
    return now


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

    # The LM kernels build in the background while the search phases run
    # (one nvcc per source, all started together); phase 5 waits.
    build_pool = ThreadPoolExecutor(max_workers=1)
    lm_build = build_pool.submit(build.build_all, LM_KERNELS)

    # -- 1. build ---------------------------------------------------------------
    phase_t0 = time.perf_counter()
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

    phase_t0 = phase_done(1, phase_t0)

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

    phase_t0 = phase_done(2, phase_t0)

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

    phase_t0 = phase_done(3, phase_t0)

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

    phase_done(4, phase_t0)

    lm_entries = lm_phases(lm_build, dev)
    build_pool.shutdown()

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
    }] + lm_entries}
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


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| in f32 (the reference's kernel-test
    measure)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel: registers, spills, shared memory."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"# ptxas {name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return lines


def roofline_ms(bytes_moved: int, ops: int, dtype) -> tuple:
    """(bound ms, what bounds it): the bytes the function must move (each
    input read once, each output written once) against the card's memory
    rate, and its operations against the dtype's peak."""
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def lm_wrappers() -> tuple:
    """The LM kernels' wrappers, whose ``launches`` count their launches."""
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.moe_gemm import grouped_gemm
    from repro_torch.kernels.rglru import rglru_scan

    return flash_attention, decode_attention, grouped_gemm, rglru_scan


def launch_counts() -> dict:
    """The LM kernels' launch counters, by kernel name."""
    return {k.__name__: k.launches for k in lm_wrappers()}


def set_launch_counts(counts: dict) -> None:
    for k in lm_wrappers():
        k.launches = counts[k.__name__]


def lm_phases(lm_build, dev) -> list:
    """Phases 5-12: the LM kernels, then qwen3-0.6b, olmoe-1b-7b and
    recurrentgemma-9b serving, each followed by its kernel path against the
    plain path.  Returns the four kernels' entries of the ``kernels`` line;
    their launches are those of the three serving main paths (phases 7, 9
    and 11)."""
    from repro_torch import build

    # -- 5. build ----------------------------------------------------------------
    phase_t0 = time.perf_counter()
    for name, secs in lm_build.result().items():
        print(f"# build: {name} in {secs:.2f} s (started with phase 1, in parallel)")
        print("\n".join(ptxas_summary(build.library_path(name).with_suffix(".log").read_text())))
    phase_t0 = phase_done(5, phase_t0)

    timing, max_abs = lm_kernel_checks(dev)
    phase_done(6, phase_t0)

    launches = {}
    for arch, shape in SERVED.items():
        main = serving_main_path(arch, shape, dev, timing)
        launches[arch] = main.pop("launches")
        kernel_path_against_plain(main, shape, dev)
        del main
        torch.cuda.empty_cache()
    check(launches["qwen3-0.6b"]["grouped_gemm"] == 0, "qwen3-0.6b launched grouped_gemm")
    check(launches["qwen3-0.6b"]["rglru_scan"] == launches["olmoe-1b-7b"]["rglru_scan"] == 0,
          "a model without recurrent layers launched rglru_scan")
    print(f"# main path launches by model: {json.dumps(launches)}")

    def entry(name, replaces, shape):
        ms, plain_ms, library_ms, bound = timing[name][shape]
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": sum(run[name] for run in launches.values()),
                "max_abs_err": max_abs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}

    return [
        entry("flash_attention", "src/repro/kernels/flash/flash_attention.py:26", "qwen3-0.6b"),
        entry("decode_attention", "src/repro/kernels/decode_attn/decode_attention.py:23", "qwen3-0.6b"),
        entry("grouped_gemm", "src/repro/kernels/moe_gemm/grouped_gemm.py:19", "prefill wi/wu"),
        entry("rglru_scan", "src/repro/kernels/rglru/rglru_scan.py:23", "recurrentgemma-9b"),
    ]


def pairs_seen(S: int, window) -> int:
    """Query-key pairs a causal attention over S tokens computes, under a
    sliding window or none."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def plain_flash_op(q, k, v, *, causal=True, window=None):
    """The flash op's plain version on model-layout (B, S, H, hd) tensors."""
    from repro_torch.kernels.flash import flash_attention_plain

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return flash_attention_plain(qt, kt, vt, causal=causal, window=window).transpose(1, 2)


def plain_decode_op(q, k_cache, v_cache, length):
    """The decode op's plain version on model-layout caches."""
    from repro_torch.kernels.decode_attn import decode_attention_plain

    return decode_attention_plain(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), length)[:, None]


def lm_kernel_checks(dev):
    """Phase 6: each LM kernel against its plain version, and their times.
    Returns ``({kernel: {shape label: (ms, plain ms, library ms, bound)}},
    {kernel: max abs error})``."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import decode_attention, decode_attention_op, decode_attention_plain
    from repro_torch.kernels.flash import flash_attention, flash_attention_op, flash_attention_plain
    from repro_torch.kernels.moe_gemm import grouped_gemm, grouped_gemm_plain
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(dtype)

    max_abs = {name: 0.0 for name in LM_KERNELS}

    def hold(name, label, got, want, dtype):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{label}: shape/dtype")
        err = rel_err(got, want)
        check(err <= TOL[dtype], f"{label}: kernel against plain, relative error {err!r}")
        max_abs[name] = max(max_abs[name], float((got.float() - want.float()).abs().max()))

    n_cases = 0
    for B, H, Kv, S, hd in FLASH_CASES:
        for dtype in (f32, bf16):
            q, k, v = randn(B, H, S, hd, dtype=dtype), randn(B, Kv, S, hd, dtype=dtype), randn(B, Kv, S, hd, dtype=dtype)
            for causal, window in FLASH_MASKS:
                label = f"flash B={B} H={H} Kv={Kv} S={S} hd={hd} {dtype} causal={causal} window={window}"
                hold("flash_attention", label, flash_attention(q, k, v, causal=causal, window=window),
                     flash_attention_plain(q, k, v, causal=causal, window=window), dtype)
                n_cases += 1
    for B, H, Kv, S, hd, lengths in DECODE_CASES:
        for dtype in (f32, bf16):
            q, k, v = randn(B, H, hd, dtype=dtype), randn(B, Kv, S, hd, dtype=dtype), randn(B, Kv, S, hd, dtype=dtype)
            for length in lengths:
                label = f"decode B={B} H={H} Kv={Kv} S={S} hd={hd} {dtype} length={length}"
                want = decode_attention_plain(q, k, v, length)
                hold("decode_attention", label, decode_attention(q, k, v, length), want, dtype)
                on_card = torch.tensor(length, dtype=torch.int32, device=dev)
                hold("decode_attention", label + " (device length)",
                     decode_attention(q, k, v, on_card), want, dtype)
                n_cases += 2

    # The model-layout ops at phases 7, 9 and 11's shapes: (B, S, heads, hd)
    # tensors, which the ops hand the kernels as transposed (strided) views.
    for dtype in (f32, bf16):
        for B, S, H, Kv, hd, window in FLASH_OP_CASES:
            q, k, v = randn(B, S, H, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype)
            hold("flash_attention", f"flash op B={B} S={S} H={H} Kv={Kv} hd={hd} window={window} {dtype}",
                 flash_attention_op(q, k, v, window=window), plain_flash_op(q, k, v, window=window), dtype)
            n_cases += 1
        for B, S, H, Kv, hd, lengths in DECODE_OP_CASES:
            q, k, v = randn(B, 1, H, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype)
            for length in lengths:
                hold("decode_attention", f"decode op B={B} cache={S} H={H} Kv={Kv} hd={hd} length={length} {dtype}",
                     decode_attention_op(q, k, v, length), plain_decode_op(q, k, v, length), dtype)
                n_cases += 1
    for E, C, D, Fd in GG_CASES:
        for dtype in (f32, bf16):
            x, w = randn(E, C, D, dtype=dtype), randn(E, D, Fd, dtype=dtype, scale=0.05)
            hold("grouped_gemm", f"grouped_gemm ({E}, {C}, {D}) @ ({E}, {D}, {Fd}) {dtype}",
                 grouped_gemm(x, w), grouped_gemm_plain(x, w), dtype)
            n_cases += 1
    for B, S, D in RGLRU_CASES:
        for dtype in (f32, bf16):
            a, x = torch.sigmoid(randn(B, S, D, dtype=f32)).to(dtype), randn(B, S, D, dtype=dtype)
            # h0 is f32 in every case; the main path's is zeros.
            for h0 in ((torch.zeros(B, D, device=dev), randn(B, D, dtype=f32)) if S >= 2047 else (randn(B, D, dtype=f32),)):
                label = f"rglru_scan ({B}, {S}, {D}) {dtype} h0={'0' if not h0.any() else 'randn'}"
                hold("rglru_scan", label, rglru_scan(a, x, h0), rglru_scan_plain(a, x, h0), dtype)
                n_cases += 1
    print(f"# LM kernels == plain versions within tolerance in {n_cases} cases; "
          f"max abs error {json.dumps(max_abs)}")

    # Times at the main paths' shapes, through the ops on model-layout tensors.
    timing = {name: {} for name in LM_KERNELS}
    # recurrentgemma-9b's window (2048) is not below S, so its local layers
    # see the causal pairs and SDPA's causal mask is the same function.
    for label, H, Kv, hd, window in (("qwen3-0.6b", 16, 8, 128, None), ("olmoe-1b-7b", 16, 16, 128, None),
                                     ("recurrentgemma-9b", 16, 1, 256, 2048)):
        B, S = 4, 2048
        q, k, v = randn(B, S, H, hd), randn(B, S, Kv, hd), randn(B, S, Kv, hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel = time_ms(lambda: flash_attention_op(q, k, v, window=window), 20)
        plain = time_ms(lambda: plain_flash_op(q, k, v, window=window), 5)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        bound = roofline_ms(2 * (2 * q.numel() + 2 * k.numel()), 4 * B * H * hd * pairs_seen(S, window), bf16)
        timing["flash_attention"][label] = (kernel, plain, lib, bound)
        print(f"# flash_attention {label} B={B} S={S} H={H} Kv={Kv} hd={hd} window={window} causal bf16: "
              f"kernel {kernel!r} ms, plain {plain!r} ms, sdpa {lib!r} ms, bound {bound[0]!r} ms by {bound[1]}")

    def time_decode(B, S, L, H, Kv, reps, hd=128):
        """(kernel, plain, sdpa ms, bound) of one decode call at length L
        over a model-layout cache of S rows."""
        q, k, v = randn(B, 1, H, hd), randn(B, S, Kv, hd), randn(B, S, Kv, hd)
        kernel = time_ms(lambda: decode_attention_op(q, k, v, L), reps)
        plain = time_ms(lambda: plain_decode_op(q, k, v, L), reps)
        qt, kl, vl = q.transpose(1, 2), k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kl, vl, enable_gqa=True), reps)
        bound = roofline_ms(2 * (2 * q.numel() + 2 * B * Kv * L * hd), 4 * B * H * hd * L, bf16)
        print(f"# decode_attention B={B} cache={S} H={H} Kv={Kv} hd={hd} length={L} bf16: kernel {kernel!r} ms, "
              f"plain {plain!r} ms, sdpa {lib!r} ms, bound {bound[0]!r} ms by {bound[1]}")
        return kernel, plain, lib, bound

    # The 64 decode steps of phases 7 and 9 run lengths 2049..2112; 2080 is their middle.
    timing["decode_attention"]["qwen3-0.6b"] = time_decode(4, 2112, 2080, 16, 8, 50)
    timing["decode_attention"]["olmoe-1b-7b"] = time_decode(4, 2112, 2080, 16, 16, 50)
    # recurrentgemma-9b's 64 decode steps read the whole 2048-row ring.
    timing["decode_attention"]["recurrentgemma-9b"] = time_decode(4, 2048, 2048, 16, 1, 50, hd=256)
    print("# extra shape, not on the main path:")
    time_decode(8, 4096, 2048, 16, 8, 50)

    for label, (E, C, D, Fd) in GG_MAIN.items():
        x, w = randn(E, C, D), randn(E, D, Fd, scale=0.05)
        reps = 20 if C > 8 else 50
        kernel = time_ms(lambda: grouped_gemm(x, w), reps)
        plain = time_ms(lambda: grouped_gemm_plain(x, w), 5)
        lib = time_ms(lambda: torch.bmm(x, w), reps)
        bound = roofline_ms(2 * (E * C * D + E * D * Fd + E * C * Fd), 2 * E * C * D * Fd, bf16)
        timing["grouped_gemm"][label] = (kernel, plain, lib, bound)
        print(f"# grouped_gemm {label} ({E}, {C}, {D}) @ ({E}, {D}, {Fd}) bf16: kernel {kernel!r} ms, "
              f"plain {plain!r} ms, torch.bmm {lib!r} ms, bound {bound[0]!r} ms by {bound[1]}")

    # The scan at recurrentgemma-9b's forward shape, f32 with a zero h0 as
    # the model gives it: 12 bytes a step and channel, 2 operations.
    B, S, D = RGLRU_MAIN
    a, x, h0 = torch.sigmoid(randn(B, S, D, dtype=f32)), randn(B, S, D, dtype=f32), torch.zeros(B, D, device=dev)
    kernel = time_ms(lambda: rglru_scan(a, x, h0), 50)
    plain = time_ms(lambda: rglru_scan_plain(a, x, h0), 3)
    bound = roofline_ms(4 * (3 * B * S * D + B * D), 2 * B * S * D, f32)
    timing["rglru_scan"]["recurrentgemma-9b"] = (kernel, plain, None, bound)
    print(f"# rglru_scan recurrentgemma-9b ({B}, {S}, {D}) f32: kernel {kernel!r} ms, plain {plain!r} ms, "
          f"no library call, bound {bound[0]!r} ms by {bound[1]}")
    return timing, max_abs


def forward_against_decode(model, prompts) -> float:
    """Relative error of ``forward``'s last position against prefill(S - 1)
    + one decode step.  A forward sees what they see at its last position
    only if no slot of that position was dropped, so an MoE model is checked
    at its dropless capacity factor E / K (the capacity is shared by the
    whole batch)."""
    import dataclasses

    from repro_torch.models import extend_cache

    cfg = model.cfg
    if cfg.n_experts:
        model.cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    S = prompts.shape[1]
    full, _, _ = model.forward({"tokens": prompts})
    full_last = full[:, -1].clone()
    del full
    _, short_cache = model.prefill({"tokens": prompts[:, :-1]})
    dec, _ = model.decode_step(extend_cache(model, short_cache, S), prompts[:, -1:], S - 1)
    torch.cuda.synchronize()
    model.cfg = cfg
    return rel_err(dec[:, 0], full_last)


def serving_main_path(arch: str, shape: dict, dev, timing: dict) -> dict:
    """Phase 7, 9 or 11: ``arch`` at full width and depth with seeded bf16
    weights — prefill of 4 × 2048, ``extend_cache`` to 2112, 64 greedy decode
    steps, ``forward``, and ``ServingEngine`` serving ``shape``'s requests —
    with each call's kernel launches checked.  The counters are set to 0
    after the warm-up; what they read after the engine run is the main
    path's ``launches``.  A check of ``forward`` against prefill(S - 1) + one
    decode step runs between (or first, on a copy in ``held_dtype``), its
    launches not counted.  Returns the model, its prompts, the fed tokens,
    the prefill and first 16 decode steps' logits, and the launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build as build_model, build_from_config, extend_cache
    from repro_torch.serve import Request, ServingEngine

    phase_t0 = time.perf_counter()
    cfg = configs.get(arch)
    rng = np.random.default_rng(shape["seed"])
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 2048)), device=dev)
    held_dtype = shape.get("held_dtype")
    if held_dtype:
        copy = build_from_config(dataclasses.replace(cfg, dtype=held_dtype), device="cuda", seed=0)
        held_err = forward_against_decode(copy, prompts)
        del copy
        torch.cuda.empty_cache()
        check(held_err <= TOL[getattr(torch, held_dtype)],
              f"{held_dtype} forward against prefill + decode_step: relative error {held_err!r}")
    model = build_model(arch, device="cuda", seed=0)
    kinds = cfg.layer_kinds()
    n_rglru = kinds.count("rglru")
    n_attn = len(kinds) - n_rglru  # "attn" and "local" layers
    gg = 3 * n_attn if cfg.n_experts else 0  # grouped-GEMM launches per call: wi, wu, wd of each MoE FFN
    n_params = sum(p.numel() for p in model.parameters())
    print(f"# {arch}: {n_params} parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    model.prefill({"tokens": prompts[:1, :128]})  # warm-up (cuBLAS handles), not timed or counted
    torch.cuda.synchronize()
    set_launch_counts({name: 0 for name in LM_KERNELS})

    def launched(forwards, steps):
        """The counts are those of ``forwards`` full-sequence passes and
        ``steps`` decode steps so far: each pass launches flash once per
        attention layer and the scan once per recurrent layer, each step
        decode attention once per attention layer and no scan, and both the
        grouped GEMM three times per MoE FFN."""
        return launch_counts() == {"flash_attention": forwards * n_attn, "decode_attention": steps * n_attn,
                                   "grouped_gemm": (forwards + steps) * gg, "rglru_scan": forwards * n_rglru}

    t0 = time.perf_counter()
    last, cache = model.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(launched(1, 0), f"prefill's launches {launch_counts()}: not flash and rglru_scan once per layer of "
          f"their kind and grouped_gemm {gg} times")
    check(bool(torch.isfinite(last).all()), "prefill logits are not finite")
    cache = extend_cache(model, cache, 2112)
    tok = last[:, -1].argmax(-1, keepdim=True)
    fed, step_logits = [], []
    t0 = time.perf_counter()
    for t in range(64):
        fed.append(tok)
        logits, cache = model.decode_step(cache, tok, 2048 + t)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        if t < 16:
            step_logits.append(logits)
    torch.cuda.synchronize()
    decode_step_ms = (time.perf_counter() - t0) * 1e3 / 64
    check(launched(1, 64), f"launches after 64 decode steps {launch_counts()}: not decode_attention once per "
          f"attention layer and grouped_gemm {gg} times per step")
    check(bool(torch.isfinite(logits).all()), "decode logits are not finite")
    del cache

    full, aux, _ = model.forward({"tokens": prompts})
    check(launched(2, 64), f"forward's launches {launch_counts()}")
    check(bool(torch.isfinite(full).all()), "forward logits are not finite")
    check(bool(torch.isfinite(aux)) and (float(aux) > 0.0) == (cfg.n_experts > 0), f"aux loss {float(aux)!r}")
    del full

    # Not the main path: its counts are kept and restored.
    counts = launch_counts()
    fwd_err = forward_against_decode(model, prompts)
    if held_dtype:
        counts_kernel = launch_counts()
        with plain_ops():
            plain_err = forward_against_decode(model, prompts)
        check(launch_counts() == counts_kernel, "the plain path launched a kernel")
    set_launch_counts(counts)
    if held_dtype:
        held = (f"{held_dtype} copy {held_err!r} (held at {TOL[getattr(torch, held_dtype)]}); "
                f"{cfg.dtype} {fwd_err!r}, with the plain versions {plain_err!r} (not held)")
    else:
        check(fwd_err <= 3e-2, f"forward against prefill + decode_step: relative error {fwd_err!r}")
        held = repr(fwd_err)
    print(f"# {arch} prefill 4 x 2048: {prefill_ms!r} ms; decode step (B=4, cache 2112): {decode_step_ms!r} ms "
          f"(mean of 64); aux loss {float(aux)!r}; {'dropless ' if cfg.n_experts else ''}forward vs "
          f"prefill+decode relative error {held}")

    rng = np.random.default_rng(shape["seed"] + 1)
    lo, hi = shape["prompt_len"]
    n, new = shape["requests"], shape["new_tokens"]
    requests = [Request(i, rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi))).astype(np.int32),
                        max_new_tokens=new) for i in range(n)]
    engine = ServingEngine(model, batch_slots=shape["slots"], max_seq=shape["max_seq"])
    t0 = time.perf_counter()
    engine.run(requests)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(all(r.done and len(r.output) == new for r in requests), f"a request did not finish with {new} tokens")
    n_decode_calls = sum(len(r.prompt) for r in requests) + engine.steps
    check(launched(2, 64 + n_decode_calls),
          f"launches after the engine {launch_counts()}: not decode_attention once per attention layer and "
          f"grouped_gemm {gg} times per step")
    print(f"# {arch} ServingEngine {shape['slots']} slots, {n} requests x {new} tokens: {serve_s!r} s, "
          f"{n * new / serve_s!r} generated tokens/s, {n_decode_calls} decode steps ({engine.steps} generating)")
    launches = launch_counts()

    # Each kernel's share of the prefill and of a decode step, at phase 6's
    # times of one call at this path's shapes.
    fl, de, gt = (timing["flash_attention"][arch][0], timing["decode_attention"][arch][0], timing["grouped_gemm"])
    scan = n_rglru * timing["rglru_scan"][arch][0] if n_rglru else 0.0
    gg_prefill = n_attn * (2 * gt["prefill wi/wu"][0] + gt["prefill wd"][0]) if gg else 0.0
    gg_decode = n_attn * (2 * gt["decode wi/wu"][0] + gt["decode wd"][0]) if gg else 0.0
    print(f"# {arch} prefill {prefill_ms!r} ms; kernels at phase 6's times: flash_attention {n_attn * fl!r} ms "
          f"({100 * n_attn * fl / prefill_ms:.1f} %), grouped_gemm {gg_prefill!r} ms "
          f"({100 * gg_prefill / prefill_ms:.1f} %), rglru_scan {scan!r} ms ({100 * scan / prefill_ms:.1f} %)")
    print(f"# {arch} decode step {decode_step_ms!r} ms; kernels at phase 6's times: decode_attention "
          f"{n_attn * de!r} ms ({100 * n_attn * de / decode_step_ms:.1f} %), grouped_gemm {gg_decode!r} ms "
          f"({100 * gg_decode / decode_step_ms:.1f} %)")
    phase_done(shape["phase"], phase_t0)
    return {"model": model, "prompts": prompts, "fed": fed[:16], "last": last, "step_logits": step_logits,
            "launches": launches}


class Routes:
    """Binds ``repro_torch.models.moe.route`` to a wrapper that keeps the
    expert indices of every MoE call, in call order; ``with`` restores it.
    Given such a record (``replay``), each call takes the recorded experts
    instead of its own top-k, with its own router probabilities gathered at
    them as gates (renormalized as ``route`` does)."""

    def __init__(self, replay=None):
        import repro_torch.models.moe as moe

        self.moe, self.route, self.replay, self.calls = moe, moe.route, replay, []

    def __enter__(self):
        def wrapped(cfg, router, xf):
            probs, gates, experts = self.route(cfg, router, xf)
            if self.replay is not None:
                experts = self.replay[len(self.calls)]
                gates = probs.gather(-1, experts)
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            self.calls.append(experts)
            return probs, gates, experts

        self.moe.route = wrapped
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def routed_apart(a: list, b: list, n_calls: int, rows: list) -> list:
    """Per forward or decode step (``n_calls`` MoE calls each, ``rows[i]``
    token rows in the i-th), a bool per token row: routed to another expert
    set at some layer."""
    check(len(a) == len(b) == n_calls * len(rows), "the two paths made different MoE calls")
    out = []
    for i in range(len(rows)):
        pairs = zip(a[i * n_calls:(i + 1) * n_calls], b[i * n_calls:(i + 1) * n_calls])
        out.append(torch.stack([(x.sort(-1).values != y.sort(-1).values).any(-1) for x, y in pairs]).any(0))
    return out


def kernel_path_against_plain(main: dict, shape: dict, dev) -> None:
    """Phase 8, 10 or 12: the model's kernel path against its plain path
    (the model's kernel ops bound to their plain versions where
    ``repro_torch.models`` calls them, ``model_ops``) at full width: prefill
    logits and 16 teacher-forced decode steps, in bf16 within 3e-2.  An MoE
    model is also run in f32 (prefill of 4 × 256, 8 steps), within 1e-4.  A
    model with a ``held_dtype`` in its ``SERVED`` entry (``shape``) is held
    on a copy in that dtype over the main path's prompts and fed tokens
    instead, its bf16 errors printed."""
    import dataclasses

    from repro_torch.models import build_from_config

    phase_t0 = time.perf_counter()
    model = main.pop("model")
    cfg = model.cfg
    held_dtype = shape.get("held_dtype")
    kernel = compare(f"{cfg.arch} {cfg.dtype}", model, main["prompts"], main["fed"],
                     None if held_dtype else TOL[torch.bfloat16], by_sequence=False)
    check(torch.equal(kernel[0], main["last"]) and all(torch.equal(a, b) for a, b in zip(kernel[1], main["step_logits"])),
          "the kernel path is not deterministic: a rerun differs from the main path's")
    if cfg.n_experts or held_dtype:
        del model, kernel
        torch.cuda.empty_cache()
        dtype = held_dtype or "float32"
        copy = build_from_config(dataclasses.replace(cfg, dtype=dtype), device="cuda", seed=0)
        if held_dtype:
            prompts, fed = main["prompts"], main["fed"]
        else:
            rng = np.random.default_rng(11)
            prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 256)), device=dev)
            fed = [torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 1)), device=dev) for _ in range(8)]
        compare(f"{cfg.arch} {dtype}", copy, prompts, fed, TOL[getattr(torch, dtype)],
                by_sequence=bool(cfg.n_experts))
    phase_done(shape["phase"] + 1, phase_t0)


def model_ops() -> list:
    """Where the model calls each kernel op, with the op's plain version:
    ``(module, name, plain)``.  Binding the names to the plain versions runs
    the plain path on the card."""
    import repro_torch.models.attention as model_attention
    import repro_torch.models.moe as model_moe
    import repro_torch.models.recurrent as model_recurrent
    from repro_torch.kernels.moe_gemm import grouped_gemm_plain
    from repro_torch.kernels.rglru import rglru_scan_plain

    return [(model_attention, "flash_attention_op", plain_flash_op),
            (model_attention, "decode_attention_op", plain_decode_op),
            (model_moe, "grouped_gemm_op", grouped_gemm_plain),
            (model_recurrent, "rglru_scan_op", rglru_scan_plain)]


@contextlib.contextmanager
def plain_ops():
    """Binds the model's kernel ops to their plain versions (``model_ops``)
    for the ``with`` block."""
    ops = model_ops()
    kernels = [getattr(module, name) for module, name, _ in ops]
    for module, name, plain in ops:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), kernel in zip(ops, kernels):
            setattr(module, name, kernel)


def compare(label: str, model, prompts, fed, tol, by_sequence: bool):
    """Prefill logits and teacher-forced decode logits of the kernel path
    against the plain path's, all held within ``tol`` (None: printed, not
    held); returns the kernel path's ``(prefill logits, step logits, expert
    indices)``.

    Two plain runs for an MoE model.  Where router logits differ in their
    last bit, the plain path can route a token to other experts than the
    kernel path, and that row then differs by far more than rounding; the
    first plain run routes on its own and counts those rows (``by_sequence``
    holds only the sequences routed alike throughout, else every row).  The
    second takes the kernel path's experts at every MoE call, so that every
    row of it measures the kernels' numerics alone."""
    from repro_torch.models import extend_cache

    def run(plain, replay=None):
        with plain_ops() if plain else contextlib.nullcontext(), Routes(replay) as routes:
            last, cache = model.prefill({"tokens": prompts})
            cache = extend_cache(model, cache, prompts.shape[1] + 64)  # the main path's cache
            steps = []
            for t, tok in enumerate(fed):
                logits, cache = model.decode_step(cache, tok, prompts.shape[1] + t)
                steps.append(logits)
        torch.cuda.synchronize()
        return [last] + steps, routes.calls

    counts = launch_counts()
    kernel, kernel_routes = run(plain=False)
    counts_kernel = launch_counts()
    plain, plain_routes = run(plain=True)
    check(launch_counts() == counts_kernel, "the plain path launched a kernel")
    B, S = prompts.shape
    # MoE calls per forward or step: one per attention layer (the MoE FFNs).
    n_calls = sum(k != "rglru" for k in model.cfg.layer_kinds()) if model.cfg.n_experts else 0
    rows_per_call = [B * S] + [B] * len(fed)
    apart = (routed_apart(kernel_routes, plain_routes, n_calls, rows_per_call) if n_calls
             else [torch.zeros(n, dtype=torch.bool, device=prompts.device) for n in rows_per_call])
    # A sequence with a token routed apart has a different cache from then on.
    seq_apart = apart[0].view(B, S).any(-1)
    errors, agree = [], 0
    for t, (k_logits, p_logits) in enumerate(zip(kernel, plain)):
        if t > 0:
            seq_apart = seq_apart | apart[t]
            agree += int((k_logits[:, -1].argmax(-1) == p_logits[:, -1].argmax(-1)).sum())
        rows = ~seq_apart if by_sequence else torch.ones_like(seq_apart)
        check(bool(rows.any()), f"{label}: every sequence was routed apart")
        errors.append(rel_err(k_logits[rows], p_logits[rows]))
        check(tol is None or errors[-1] <= tol,
              f"{label} {'prefill' if t == 0 else f'step {t}'}, kernel against plain path: "
              f"relative error {errors[-1]!r}")
    n_steps = len(fed)
    print(f"# {label} kernel path {'==' if tol else 'against'} plain path: max relative error {max(errors)!r} "
          f"over prefill {B} x {S} and {n_steps} teacher-forced steps"
          f"{' (sequences routed alike)' if by_sequence else ''}{'' if tol else ' (not held)'}; greedy tokens "
          f"agree {agree}/{B * n_steps}")
    if n_calls:
        print(f"# {label} token rows routed apart at some layer: prefill {int(apart[0].sum())}/{B * S}, decode "
              f"{int(sum(a.sum() for a in apart[1:]))}/{B * n_steps}, sequences {int(seq_apart.sum())}/{B}")
        replayed, replayed_routes = run(plain=True, replay=kernel_routes)
        check(launch_counts() == counts_kernel, "the plain path launched a kernel")
        check(all(torch.equal(a, b) for a, b in zip(replayed_routes, kernel_routes)), "the replay changed a route")
        errors = [rel_err(k, p) for k, p in zip(kernel, replayed)]
        check(tol is None or max(errors) <= tol, f"{label}, kernel against plain path on the kernel path's routes: "
              f"relative errors {errors!r}")
        print(f"# {label} kernel path == plain path on the kernel path's routes: max relative error "
              f"{max(errors)!r} over every row of the prefill and the {n_steps} steps")
    # Only the main path's launches are counted.
    set_launch_counts(counts)
    return kernel[0], kernel[1:], kernel_routes


if __name__ == "__main__":
    main()
