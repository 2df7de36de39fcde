from .ops import rglru_scan_op
from .rglru_scan import rglru_scan, rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_op", "rglru_scan_plain"]
