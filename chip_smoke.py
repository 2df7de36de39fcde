"""Drive the PyTorch/CUDA port on one CUDA card: the placement search and
LM serving on qwen3-0.6b.

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
5. attention build: ``flash_attention.cu`` and ``decode_attention.cu``
   (started in the background with phase 1, one nvcc each), their build
   seconds and ptxas reports;
6. attention kernels against their plain versions on the card (relative
   max error ≤ 1e-4 in f32, ≤ 3e-2 in bf16): flash on four shapes under
   causal, bidirectional and window-256 masks, decode at B=8 / cache 4096
   over five lengths (host and device lengths) and at G=3 / hd 64; then
   both through the model-layout ops (strided views) at the shapes phase 7
   gives them: flash over 4 × 2048 and 4 × 2047 tokens, decode at B=4 /
   cache 2112 and at the engine's B=8 / cache 512; times of kernel, plain
   version and ``scaled_dot_product_attention`` (a yardstick, never on the
   path) at phase 7's shapes, with the card's bound, and the decode
   kernel's time at B=8 / cache 4096 as an extra shape;
7. main path: qwen3-0.6b at full width and depth with seeded bf16 weights —
   ``prefill`` of 4 × 2048 tokens, ``extend_cache`` to 2112, 64 greedy
   ``decode_step``s, ``forward`` against prefill + one decode step, and
   ``ServingEngine(batch_slots=8, max_seq=512)`` serving 16 requests of 32
   new tokens; the launch counters must show 28 flash launches per forward
   and 28 decode launches per step;
8. the same weights and prompts with the model's attention ops bound to
   the plain versions: prefill logits and 16 teacher-forced decode steps
   within 3e-2 of the kernel path.

Each phase prints its seconds.  The second-to-last lines are the card's
nvidia-smi line and a JSON object with the three kernels' numbers; the last
line is the device contract line.
"""

from __future__ import annotations

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

ATTENTION_KERNELS = ["flash_attention", "decode_attention"]
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
#: The shapes phase 7 gives the model-layout ops (H=16, Kv=8, hd=128):
#: flash (B, S) of prefill and of the prefill of S - 1 tokens; decode
#: (B, cache, lengths) of the 64 decode steps and of the engine (prompts of
#: up to 128 tokens plus 32 new ones).
FLASH_OP_CASES = [(4, 2048), (4, 2047)]
DECODE_OP_CASES = [(4, 2112, (2049, 2080, 2112)), (8, 512, (1, 17, 100, 160))]


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

    # The attention kernels build in the background while the search phases
    # run (one nvcc per source, all started together); phase 5 waits.
    build_pool = ThreadPoolExecutor(max_workers=1)
    attention_build = build_pool.submit(build.build_all, ATTENTION_KERNELS)

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

    attention_entries = lm_phases(attention_build, dev)
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
    }] + attention_entries}
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


def attention_bound_ms(q_bytes: int, kv_bytes: int, ops: int, dtype) -> tuple:
    """(bound ms, what bounds it): each input read once and the output
    (q's size) written once, against the operations at the dtype's peak."""
    bytes_ms = (2 * q_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def lm_phases(attention_build, dev) -> list:
    """Phases 5-8: the attention kernels and qwen3-0.6b serving.  Returns
    the two kernels' entries of the ``kernels`` line."""
    import torch.nn.functional as F

    import repro_torch.models.attention as model_attention
    from repro_torch import build
    from repro_torch.kernels.decode_attn import decode_attention, decode_attention_op, decode_attention_plain
    from repro_torch.kernels.flash import flash_attention, flash_attention_op, flash_attention_plain
    from repro_torch.models import build as build_model, extend_cache
    from repro_torch.serve import Request, ServingEngine

    bf16, f32 = torch.bfloat16, torch.float32

    # -- 5. build ----------------------------------------------------------------
    phase_t0 = time.perf_counter()
    for name, secs in attention_build.result().items():
        print(f"# build: {name} in {secs:.2f} s (started with phase 1, in parallel)")
        print("\n".join(ptxas_summary(build.library_path(name).with_suffix(".log").read_text())))
    phase_t0 = phase_done(5, phase_t0)

    # -- 6. kernels against their plain versions ------------------------------------
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    max_abs = {"flash_attention": 0.0, "decode_attention": 0.0}

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

    # The model-layout ops at phase 7's shapes: (B, S, heads, hd) tensors,
    # which the ops hand the kernels as transposed (strided) views.
    def plain_flash_op(q, k, v, *, causal=True, window=None):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return flash_attention_plain(qt, kt, vt, causal=causal, window=window).transpose(1, 2)

    def plain_decode_op(q, k_cache, v_cache, length):
        return decode_attention_plain(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), length)[:, None]

    H, Kv, hd = 16, 8, 128
    for dtype in (f32, bf16):
        for B, S in FLASH_OP_CASES:
            q, k, v = randn(B, S, H, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype)
            hold("flash_attention", f"flash op B={B} S={S} {dtype}", flash_attention_op(q, k, v),
                 plain_flash_op(q, k, v), dtype)
            n_cases += 1
        for B, S, lengths in DECODE_OP_CASES:
            q, k, v = randn(B, 1, H, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype), randn(B, S, Kv, hd, dtype=dtype)
            for length in lengths:
                hold("decode_attention", f"decode op B={B} cache={S} length={length} {dtype}",
                     decode_attention_op(q, k, v, length), plain_decode_op(q, k, v, length), dtype)
                n_cases += 1
    print(f"# attention kernels == plain versions within tolerance in {n_cases} cases; "
          f"max abs error {json.dumps(max_abs)}")

    # Times at phase 7's shapes, through the ops on model-layout tensors.
    B, S = 4, 2048
    q, k, v = randn(B, S, H, hd), randn(B, S, Kv, hd), randn(B, S, Kv, hd)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash_ms = time_ms(lambda: flash_attention_op(q, k, v), 20)
    flash_plain_ms = time_ms(lambda: plain_flash_op(q, k, v), 5)
    flash_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    pairs = S * (S + 1) // 2
    flash_bound = attention_bound_ms(q.numel() * 2, 2 * k.numel() * 2, 4 * B * H * hd * pairs, bf16)
    print(f"# flash_attention B={B} S={S} causal bf16: kernel {flash_ms!r} ms, plain {flash_plain_ms!r} ms, "
          f"sdpa {flash_lib_ms!r} ms, bound {flash_bound[0]!r} ms by {flash_bound[1]}")

    def time_decode(B, S, L, reps):
        """(kernel, plain, sdpa ms, bound) of one decode call at length L
        over a model-layout cache of S rows."""
        q, k, v = randn(B, 1, H, hd), randn(B, S, Kv, hd), randn(B, S, Kv, hd)
        kernel = time_ms(lambda: decode_attention_op(q, k, v, L), reps)
        plain = time_ms(lambda: plain_decode_op(q, k, v, L), reps)
        qt, kl, vl = q.transpose(1, 2), k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kl, vl, enable_gqa=True), reps)
        bound = attention_bound_ms(q.numel() * 2, 2 * B * Kv * L * hd * 2, 4 * B * H * hd * L, bf16)
        print(f"# decode_attention B={B} cache={S} length={L} bf16: kernel {kernel!r} ms, plain {plain!r} ms, "
              f"sdpa {lib!r} ms, bound {bound[0]!r} ms by {bound[1]}")
        return kernel, plain, lib, bound

    # The 64 decode steps of phase 7 run lengths 2049..2112; 2080 is their middle.
    decode_ms, decode_plain_ms, decode_lib_ms, decode_bound = time_decode(4, 2112, 2080, 50)
    print("# extra shape, not on the main path:")
    time_decode(8, 4096, 2048, 50)
    phase_t0 = phase_done(6, phase_t0)

    # -- 7. main path: qwen3-0.6b at full width and depth -----------------------------
    model = build_model("qwen3-0.6b", device="cuda", seed=0)
    cfg = model.cfg
    n_layers = cfg.n_layers
    rng = np.random.default_rng(7)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 2048)), device=dev)
    model.prefill({"tokens": prompts[:1, :128]})  # warm-up (cuBLAS handles), not timed
    torch.cuda.synchronize()
    flash_attention.launches = 0
    decode_attention.launches = 0

    t0 = time.perf_counter()
    last, cache = model.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(flash_attention.launches == n_layers, f"prefill launched flash {flash_attention.launches} times")
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
    check(decode_attention.launches == 64 * n_layers,
          f"64 decode steps launched decode_attention {decode_attention.launches} times")
    check(bool(torch.isfinite(logits).all()), "decode logits are not finite")

    before = flash_attention.launches
    full, _, _ = model.forward({"tokens": prompts})
    check(flash_attention.launches - before == n_layers, "forward did not launch flash once per layer")
    _, short_cache = model.prefill({"tokens": prompts[:, :-1]})
    dec, _ = model.decode_step(extend_cache(model, short_cache, 2048), prompts[:, -1:], 2047)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(full).all()), "forward logits are not finite")
    fwd_err = rel_err(dec[:, 0], full[:, -1])
    check(fwd_err <= 3e-2, f"forward against prefill + decode_step: relative error {fwd_err!r}")
    del full
    print(f"# qwen3-0.6b prefill 4 x 2048: {prefill_ms!r} ms; decode step (B=4, cache 2112): "
          f"{decode_step_ms!r} ms; forward vs prefill+decode relative error {fwd_err!r}")

    rng = np.random.default_rng(8)
    requests = [Request(i, rng.integers(0, cfg.vocab, size=int(rng.integers(16, 129))).astype(np.int32),
                        max_new_tokens=32) for i in range(16)]
    engine = ServingEngine(model, batch_slots=8, max_seq=512)
    before = decode_attention.launches
    t0 = time.perf_counter()
    engine.run(requests)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(all(r.done and len(r.output) == 32 for r in requests), "a request did not finish with 32 tokens")
    n_decode_calls = sum(len(r.prompt) for r in requests) + engine.steps
    check(decode_attention.launches - before == n_layers * n_decode_calls,
          "the engine did not launch decode_attention once per layer and step")
    tokens_per_s = 16 * 32 / serve_s
    print(f"# ServingEngine 8 slots, 16 requests x 32 tokens: {serve_s!r} s, {tokens_per_s!r} generated "
          f"tokens/s, {n_decode_calls} decode steps ({engine.steps} generating)")
    main_launches = {"flash_attention": flash_attention.launches,
                     "decode_attention": decode_attention.launches}
    print(f"# main path launches: {json.dumps(main_launches)}")
    phase_t0 = phase_done(7, phase_t0)

    # -- 8. kernel path against plain path at full width ------------------------------
    # The model calls its attention ops through repro_torch.models.attention;
    # binding them there to the plain versions gives the plain path.
    kernel_ops = model_attention.flash_attention_op, model_attention.decode_attention_op
    model_attention.flash_attention_op, model_attention.decode_attention_op = plain_flash_op, plain_decode_op
    plain_last, plain_cache = model.prefill({"tokens": prompts})
    err = rel_err(plain_last, last)
    check(err <= 3e-2, f"prefill logits, kernel against plain path: relative error {err!r}")
    errors = [err]
    plain_cache = extend_cache(model, plain_cache, 2112)
    agree = 0
    for t in range(16):
        logits, plain_cache = model.decode_step(plain_cache, fed[t], 2048 + t)
        err = rel_err(step_logits[t], logits)
        check(err <= 3e-2, f"decode step {t}, kernel against plain path: relative error {err!r}")
        errors.append(err)
        agree += int((step_logits[t][:, -1].argmax(-1) == logits[:, -1].argmax(-1)).sum())
    torch.cuda.synchronize()
    check(flash_attention.launches == main_launches["flash_attention"]
          and decode_attention.launches == main_launches["decode_attention"],
          "the plain path launched a kernel")
    model_attention.flash_attention_op, model_attention.decode_attention_op = kernel_ops
    print(f"# kernel path == plain path: max relative error {max(errors)!r} over prefill and 16 "
          f"teacher-forced steps; greedy tokens agree {agree}/{16 * 4}")
    phase_done(8, phase_t0)

    def entry(name, replaces, ms, plain_ms, bound, library_ms):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": main_launches[name], "max_abs_err": max_abs[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    return [
        entry("flash_attention", "src/repro/kernels/flash/flash_attention.py:26",
              flash_ms, flash_plain_ms, flash_bound, flash_lib_ms),
        entry("decode_attention", "src/repro/kernels/decode_attn/decode_attention.py:23",
              decode_ms, decode_plain_ms, decode_bound, decode_lib_ms),
    ]


if __name__ == "__main__":
    main()
