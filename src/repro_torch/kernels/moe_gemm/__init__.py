from .grouped_gemm import grouped_gemm, grouped_gemm_plain
from .ops import grouped_gemm_op

__all__ = ["grouped_gemm", "grouped_gemm_op", "grouped_gemm_plain"]
