"""Fused candidate scoring: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_fused_kernel`` of
``repro/core/search/kernels/fused_score.py`` (one ``pl.pallas_call`` per
``(B, T)`` candidate block).  One call scores every candidate row for all
four objective terms — edge-gather netcost plus the migration term,
hard-capacity overshoot, the dead-node count and, with a
``ThroughputModel``, the locality-aware proxy ``min(source, cpu,
bandwidth, ack) × sink_rate``.

* ``fused_score(inputs, P)`` is the wrapper.  For a placement batch on the
  card it launches ``csrc/fused_score.cu`` (one thread block per candidate
  row, accumulators in shared memory; built at first use for ``sm_90a``
  with ``-fmad=false``) and adds one to ``fused_score.launches``.  For a
  batch on the CPU it takes the plain version.  There is no fallback from
  the card to the plain version.
* ``fused_score_plain(ba, P, tm)`` is the plain PyTorch version: the
  gather / ``index_add_`` form of the reference's numpy evaluator and
  ``throughput_batch``, batched over rows.  The CPU path and the card-side
  check use it.

What bounds the kernel on an H100: not device memory (the candidate rows
and arena tables are a few MB) but the L2 traffic of every block re-reading
the shared edge tables, about 57 bytes per task edge, twice per candidate
(about 2.2 MB per candidate on the 1000-task chain case).  The design keeps
all scatters in shared memory; amortizing the edge tables over several
candidates per block is later work.

Exactness: every summand sits on a dyadic grid, so fp64 sums are exact in
any order — shared-memory atomics included — and the elementwise tail is
IEEE double arithmetic in the reference's order.  The kernel is held to the
plain version with ``torch.equal``, never a tolerance.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from ..batch import BatchArena
from ..throughput import ThroughputModel, locality_proxy

#: Largest dynamic shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448

_PTR_FIELDS = (
    "P", "net", "avail", "demand", "alive", "edges", "evalid", "move_base",
    "move_cost", "task_cpu", "task_mem", "cpu_cap", "mem_cap", "edge_bytes",
    "edge_comp", "edge_lat", "den_flow", "rack_of", "edge_local", "pair_key",
    "combo_ce", "local_num", "ack_tab", "svc",
    "out_net", "out_viol", "out_dead", "out_tp",
)
_DOUBLE_FIELDS = (
    "nic_bw", "rack_bw", "thrash_factor", "source_bound", "sink_rate",
    "pending", "ack_overhead",
)
_INT_FIELDS = (
    "B", "T", "N", "Dh", "E", "R", "K", "n_ce", "n_comp", "n_dp", "n_pairs",
    "n_spouts", "with_tp", "acked",
)


class _FusedArgs(ctypes.Structure):
    """Mirror of ``struct FusedArgs`` in ``csrc/fused_score.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in _PTR_FIELDS]
        + [(n, ctypes.c_double) for n in _DOUBLE_FIELDS]
        + [(n, ctypes.c_int) for n in _INT_FIELDS]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ....build import load_library  # builds csrc/fused_score.cu at first use

    lib = load_library("fused_score")
    lib.fused_score_launch.argtypes = [ctypes.POINTER(_FusedArgs), ctypes.c_void_p]
    lib.fused_score_launch.restype = ctypes.c_int
    lib.fused_score_smem_bytes.argtypes = [ctypes.POINTER(_FusedArgs)]
    lib.fused_score_smem_bytes.restype = ctypes.c_longlong
    return lib


@dataclasses.dataclass(frozen=True)
class FusedInputs:
    """The arena and model a batch is scored against, plus — on the card —
    the kernel's tables, packed once (int32 indices, E and Dh padded to at
    least 1 with zero-contribution entries, the ack recursion flattened)."""

    ba: BatchArena
    tm: Optional[ThroughputModel]
    tables: Optional[Dict[str, torch.Tensor]] = None
    scalars: Optional[Dict[str, float]] = None
    dims: Optional[Dict[str, int]] = None


def _pack(ba: BatchArena, tm: Optional[ThroughputModel]):
    """Kernel tables on the arena's device — the counterpart of the
    reference's ``_padded_inputs``: a (0, 0) dummy edge with zero weights
    scores 0 in every term, and a zero demand column violates nothing."""
    dev = ba.device
    f64, i32, u8 = torch.float64, torch.int32, torch.uint8
    N, T = ba.n_nodes, ba.n_tasks
    Dh = ba.avail.shape[1]
    E = ba.edges.shape[0]
    mb, mc = ba.move_arrays()
    t: Dict[str, torch.Tensor] = {
        "net": ba.net.to(f64).contiguous(),
        "avail": ba.avail if Dh else torch.zeros(N, 1, dtype=f64, device=dev),
        "demand": ba.hard_demand if Dh else torch.zeros(T, 1, dtype=f64, device=dev),
        "alive": ba.alive.to(u8),
        "edges": ba.edges.to(i32) if E else torch.zeros(1, 2, dtype=i32, device=dev),
        "evalid": torch.ones(E, dtype=f64, device=dev) if E
        else torch.zeros(1, dtype=f64, device=dev),
        "move_base": mb.to(i32),
        "move_cost": mc.to(f64),
    }
    dims = {"T": T, "N": N, "Dh": max(Dh, 1), "E": max(E, 1), "with_tp": 0,
            "R": 1, "K": 1, "n_ce": 1, "n_comp": 0, "n_dp": 0, "n_pairs": 0,
            "n_spouts": 0, "acked": 0}
    scalars = dict.fromkeys(_DOUBLE_FIELDS, 0.0)
    if tm is not None:
        def edge_table(a, dtype, shape):
            return a.to(dtype) if E else torch.zeros(shape, dtype=dtype, device=dev)

        ack = tm.ack
        offs, ce_list, d_list = [0], [], []
        for _, downs in ack.dp:
            ce_list += [ce for ce, _ in downs]
            d_list += [d for _, d in downs]
            offs.append(len(ce_list))
        ack_tab = [ci for ci, _ in ack.dp] + offs + ce_list + d_list + list(ack.spouts)
        t.update(
            task_cpu=tm.task_cpu, task_mem=tm.task_mem,
            cpu_cap=tm.cpu_cap, mem_cap=tm.mem_cap,
            edge_bytes=edge_table(tm.edge_bytes, f64, (1,)),
            edge_comp=edge_table(tm.edge_comp, i32, (1,)),
            edge_lat=edge_table(tm.edge_lat, f64, (3, 1)),
            den_flow=tm.den_flow,
            rack_of=tm.rack_of.to(i32),
            edge_local=edge_table(tm.edge_local, u8, (1,)),
            pair_key=edge_table(tm.pair_key, i32, (1,)),
            combo_ce=tm.combo_ce.to(i32),
            local_num=tm.local_num,
            ack_tab=torch.tensor(ack_tab, dtype=i32, device=dev),
            svc=torch.tensor(ack.svc, dtype=f64, device=dev),
        )
        dims.update(
            with_tp=1, R=max(tm.n_racks, 1), K=tm.n_combos,
            n_ce=max(ack.n_comp_edges, 1), n_comp=len(ack.svc),
            n_dp=len(ack.dp), n_pairs=len(ce_list), n_spouts=len(ack.spouts),
            acked=int(ack.acked),
        )
        scalars.update(
            nic_bw=tm.nic_bw, rack_bw=tm.rack_bw, thrash_factor=tm.thrash_factor,
            source_bound=tm.source_bound, sink_rate=tm.sink_rate,
            pending=ack.pending, ack_overhead=ack.ack_overhead_s,
        )
    t = {k: v.contiguous() for k, v in t.items()}
    return t, scalars, dims


def fused_inputs(ba: BatchArena, tm: Optional[ThroughputModel] = None) -> FusedInputs:
    """Bind an uploaded arena (and model) for scoring; on the card this
    packs the kernel's tables once for every later ``fused_score`` call."""
    if ba.device.type != "cuda":
        return FusedInputs(ba, tm)
    tables, scalars, dims = _pack(ba, tm)
    return FusedInputs(ba, tm, tables, scalars, dims)


def fused_score(
    inputs: FusedInputs, P: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Score a ``(B, T)`` batch: ``(net, violation, dead, throughput)`` as
    float64/float64/int64/float64 tensors (``throughput`` None without a
    model).  The CUDA kernel for a batch on the card, the plain version for
    a batch on the CPU."""
    if P.device.type == "cpu":
        return fused_score_plain(inputs.ba, P, inputs.tm)
    if P.device.type != "cuda" or inputs.tables is None:
        raise ValueError(
            f"fused_score: batch on {P.device}, arena on {inputs.ba.device}; "
            "both must be on the same CUDA device or both on the CPU"
        )
    tables, dims = inputs.tables, inputs.dims
    if P.device != tables["net"].device:
        raise ValueError(f"batch on {P.device}, arena on {tables['net'].device}")
    if P.dim() != 2 or P.shape[1] != dims["T"]:
        raise ValueError(f"batch shape {tuple(P.shape)}, expected (B, {dims['T']})")
    if P.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"placements must be int32 or int64, got {P.dtype}")
    B = P.shape[0]
    dev = P.device
    net = torch.empty(B, dtype=torch.float64, device=dev)
    viol = torch.empty(B, dtype=torch.float64, device=dev)
    dead = torch.empty(B, dtype=torch.int64, device=dev)
    tp = torch.empty(B, dtype=torch.float64, device=dev) if dims["with_tp"] else None
    if B == 0:
        return net, viol, dead, tp
    P32 = P.to(torch.int32).contiguous()
    args = _FusedArgs(B=B, **dims, **inputs.scalars)
    for name, tensor in tables.items():
        setattr(args, name, tensor.data_ptr())
    args.P = P32.data_ptr()
    args.out_net, args.out_viol, args.out_dead = (
        net.data_ptr(), viol.data_ptr(), dead.data_ptr(),
    )
    args.out_tp = tp.data_ptr() if tp is not None else None
    lib = _library()
    smem = lib.fused_score_smem_bytes(ctypes.byref(args))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_score needs {smem} B of shared memory per block, the card "
            f"allows {MAX_SMEM_BYTES} B (N={dims['N']}, T={dims['T']})"
        )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_score_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"fused_score kernel launch failed: CUDA error {err}")
    fused_score.launches += 1
    return net, viol, dead, tp


fused_score.launches = 0


def fused_score_plain(
    ba: BatchArena, P: torch.Tensor, tm: Optional[ThroughputModel] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of the kernel on the same inputs: the
    gather / ``index_add_`` form of the reference's ``_evaluate_numpy`` and
    ``throughput_batch``, batched over rows (and on whatever device ``P``
    and the arena share)."""
    B = P.shape[0]
    if ba.edges.shape[0]:
        net = ba.net[P[:, ba.edges[:, 0]], P[:, ba.edges[:, 1]]].sum(dim=-1)
    else:
        net = torch.zeros(B, dtype=torch.float64, device=P.device)
    if ba.move_cost is not None:
        # Same edge-sum + move-sum decomposition as the reference; dyadic
        # costs make the sum order-independent.
        net = net + torch.where(P != ba.move_base, ba.move_cost, 0.0).sum(dim=-1)
    viol = (ba.used(P) - ba.avail).clamp_min(0.0).sum(dim=(1, 2))
    dead = (~ba.alive[P]).sum(dim=-1)
    tp = locality_proxy(ba, tm, P) if tm is not None else None
    return net, viol, dead, tp
