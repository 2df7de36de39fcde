"""Arena-backed node selection — the vectorized twin of ``NodeSelector``.

Holds the Ref Node across calls (Alg 4's ``global refNode``) exactly like the
dict path, including re-establishment when the anchor dies, and supports the
upstream-peer credit discount as a first-class option (mirroring
``NodeSelector.select(..., credit_nodes=...)``).  Distance weights live on
the arena (passed at compile time).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .arena import PlacementArena


class ArenaSelector:
    def __init__(self, arena: PlacementArena):
        self.arena = arena
        self.ref_node: Optional[int] = None

    def _ensure_ref(self) -> int:
        if self.ref_node is None or not self.arena.alive[self.ref_node]:
            self.ref_node = self.arena.establish_ref_node()
        return self.ref_node

    def select(
        self,
        demand_row: np.ndarray,
        hard_cols: np.ndarray,
        credit_mask: Optional[np.ndarray] = None,
        credit: Optional[float] = None,
    ) -> Optional[int]:
        """Argmin-distance feasible node index, or None (task unassigned)."""
        ref = self._ensure_ref()
        return self.arena.select(
            demand_row, hard_cols, ref, credit_mask=credit_mask, credit=credit
        )
