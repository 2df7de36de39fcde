# Batched placement-search subsystem in PyTorch: lifts the PlacementArena's
# dense arrays into a BatchArena, uploads it once to a device, and evaluates
# thousands of candidate placements in parallel (the fused CUDA kernel on the
# card, its plain torch version on the CPU — see .kernels).  Two objectives:
# network cost (QM3DKP) and the simulator-derived throughput proxy (what the
# paper's §6 actually measures).
from .backend import resolve_device
from .batch import BatchArena
from .objective import BatchEval, evaluate_batch
from .throughput import ThroughputModel, compile_throughput, throughput_batch
from .anneal import BatchAnnealer, OBJECTIVES
from .portfolio import SearchScheduler

__all__ = [
    "BatchAnnealer",
    "BatchArena",
    "BatchEval",
    "OBJECTIVES",
    "SearchScheduler",
    "ThroughputModel",
    "compile_throughput",
    "evaluate_batch",
    "resolve_device",
    "throughput_batch",
]
