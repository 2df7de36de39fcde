# Array-backed placement engine: the vectorized scheduling core the R-Storm
# scheduler and the batched search run on.
from .arena import PlacementArena, swap_network_delta, swap_overload_delta
from .selection import ArenaSelector
from .annealing import OVERLOAD_PENALTY

__all__ = [
    "ArenaSelector",
    "OVERLOAD_PENALTY",
    "PlacementArena",
    "swap_network_delta",
    "swap_overload_delta",
]
