"""Geometric regions (host-side, used at setup time).

The block region of the reference (src/region_block.cpp).  ``inside`` uses
the reference's inclusive-boundary match semantics (lo <= x <= hi).
"""

from __future__ import annotations

import numpy as np


class Region:
    def inside(self, pts: np.ndarray) -> np.ndarray:  # (N,3) -> (N,) bool
        raise NotImplementedError

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class BlockRegion(Region):
    def __init__(self, lo, hi):
        self.lo = np.asarray(lo, dtype=np.float64)
        self.hi = np.asarray(hi, dtype=np.float64)

    def inside(self, pts):
        return np.all((pts >= self.lo) & (pts <= self.hi), axis=1)

    def bounding_box(self):
        return self.lo.copy(), self.hi.copy()
