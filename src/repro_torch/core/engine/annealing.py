"""Soft-overload penalty shared with the sequential swap annealer.

The sequential ``SwapAnnealer`` comes with a later slice of the port; the
batched search only needs its penalty weight, so accept thresholds mean the
same thing in both engines.
"""

#: Same soft-overload penalty weight as the legacy annealer cost.
OVERLOAD_PENALTY = 1e6
