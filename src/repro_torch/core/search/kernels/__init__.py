# Hand-written CUDA kernel layer for the batched placement search: one fused
# kernel scoring a (B, T) candidate block for netcost, hard-capacity
# violation, dead-node hits and the throughput proxy in a single pass (the
# port of the reference's Pallas ``fused_score``), beside its plain torch
# version.  Both are bit-identical to the reference's numpy backend by the
# dyadic-grid argument.
from .fused_score import fused_inputs, fused_score, fused_score_plain

__all__ = ["fused_inputs", "fused_score", "fused_score_plain"]
