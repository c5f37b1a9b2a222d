"""Geometric regions (host-side, used at setup time).

The region styles of tpumd/core/region.py: block, sphere, prism, cylinder,
cone, plane, ellipsoid (src/region_*.cpp), ``side out`` and the union and
intersect of other regions.  ``inside`` uses the reference's
inclusive-boundary match semantics (lo <= x <= hi).
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


class SphereRegion(Region):
    def __init__(self, center, radius):
        self.center = np.asarray(center, dtype=np.float64)
        self.radius = float(radius)

    def inside(self, pts):
        d2 = np.sum((pts - self.center) ** 2, axis=1)
        return d2 <= self.radius * self.radius

    def bounding_box(self):
        r = self.radius
        return self.center - r, self.center + r


class PrismRegion(Region):
    """Triclinic box region (src/region_prism.cpp): block + xy/xz/yz tilt."""

    def __init__(self, lo, hi, tilt):
        self.lo = np.asarray(lo, dtype=np.float64)
        self.hi = np.asarray(hi, dtype=np.float64)
        self.tilt = np.asarray(tilt, dtype=np.float64)  # xy, xz, yz

    def _lamda(self, pts):
        ell = self.hi - self.lo
        xy, xz, yz = self.tilt
        d = pts - self.lo
        lz = d[:, 2] / ell[2]
        ly = (d[:, 1] - yz * lz) / ell[1]
        lx = (d[:, 0] - xy * ly - xz * lz) / ell[0]
        return np.stack([lx, ly, lz], axis=1)

    def inside(self, pts):
        lam = self._lamda(np.asarray(pts, dtype=np.float64))
        return np.all((lam >= 0.0) & (lam <= 1.0), axis=1)

    def bounding_box(self):
        return self.lo.copy(), self.hi.copy()


class CylinderRegion(Region):
    """Axis-aligned cylinder (src/region_cylinder.cpp): ``dim`` is the
    cylinder axis, (c1, c2) the center in the two remaining dims."""

    def __init__(self, dim, c1, c2, radius, lo, hi):
        self.dim = int(dim)
        self.c1 = float(c1)
        self.c2 = float(c2)
        self.radius = float(radius)
        self.lo = float(lo)
        self.hi = float(hi)
        self._o1, self._o2 = [c for c in range(3) if c != self.dim]

    def inside(self, pts):
        pts = np.asarray(pts, dtype=np.float64)
        d1 = pts[:, self._o1] - self.c1
        d2 = pts[:, self._o2] - self.c2
        ax = pts[:, self.dim]
        return ((d1 * d1 + d2 * d2 <= self.radius * self.radius)
                & (ax >= self.lo) & (ax <= self.hi))

    def bounding_box(self):
        lo = np.empty(3)
        hi = np.empty(3)
        lo[self.dim], hi[self.dim] = self.lo, self.hi
        lo[self._o1], hi[self._o1] = self.c1 - self.radius, self.c1 + self.radius
        lo[self._o2], hi[self._o2] = self.c2 - self.radius, self.c2 + self.radius
        return lo, hi


class ConeRegion(Region):
    """Axis-aligned cone frustum (src/region_cone.cpp): radius varies
    linearly from radlo at ``lo`` to radhi at ``hi``."""

    def __init__(self, dim, c1, c2, radlo, radhi, lo, hi):
        self.dim = int(dim)
        self.c1 = float(c1)
        self.c2 = float(c2)
        self.radlo = float(radlo)
        self.radhi = float(radhi)
        self.lo = float(lo)
        self.hi = float(hi)
        self._o1, self._o2 = [c for c in range(3) if c != self.dim]

    def inside(self, pts):
        pts = np.asarray(pts, dtype=np.float64)
        d1 = pts[:, self._o1] - self.c1
        d2 = pts[:, self._o2] - self.c2
        ax = pts[:, self.dim]
        frac = np.where(self.hi > self.lo,
                        (ax - self.lo) / max(self.hi - self.lo, 1e-300),
                        0.0)
        rad = self.radlo + frac * (self.radhi - self.radlo)
        return ((d1 * d1 + d2 * d2 <= rad * rad)
                & (ax >= self.lo) & (ax <= self.hi))

    def bounding_box(self):
        r = max(self.radlo, self.radhi)
        lo = np.empty(3)
        hi = np.empty(3)
        lo[self.dim], hi[self.dim] = self.lo, self.hi
        lo[self._o1], hi[self._o1] = self.c1 - r, self.c1 + r
        lo[self._o2], hi[self._o2] = self.c2 - r, self.c2 + r
        return lo, hi


class PlaneRegion(Region):
    """Half-space (src/region_plane.cpp): inside = the side the normal
    points toward (n . (x - p) >= 0)."""

    def __init__(self, point, normal):
        self.point = np.asarray(point, dtype=np.float64)
        n = np.asarray(normal, dtype=np.float64)
        self.normal = n / np.linalg.norm(n)

    def inside(self, pts):
        return (np.asarray(pts, np.float64) - self.point) @ self.normal >= 0.0

    def bounding_box(self):
        return (np.full(3, -np.inf), np.full(3, np.inf))


class EllipsoidRegion(Region):
    """Axis-aligned ellipsoid (src/region_ellipsoid.cpp)."""

    def __init__(self, center, abc):
        self.center = np.asarray(center, dtype=np.float64)
        self.abc = np.asarray(abc, dtype=np.float64)

    def inside(self, pts):
        rel = (np.asarray(pts, np.float64) - self.center) / self.abc
        return np.sum(rel * rel, axis=1) <= 1.0

    def bounding_box(self):
        return self.center - self.abc, self.center + self.abc


class OutsideRegion(Region):
    """side out wrapper: complement of the wrapped region
    (Region::side, src/region.cpp)."""

    def __init__(self, inner):
        self.inner = inner

    def inside(self, pts):
        return ~self.inner.inside(pts)

    def bounding_box(self):
        return (np.full(3, -np.inf), np.full(3, np.inf))


class UnionRegion(Region):
    """region union (src/region_union.cpp)."""

    def __init__(self, regions):
        self.regions = list(regions)

    def inside(self, pts):
        out = self.regions[0].inside(pts)
        for r in self.regions[1:]:
            out = out | r.inside(pts)
        return out

    def bounding_box(self):
        los, his = zip(*[r.bounding_box() for r in self.regions])
        return np.min(los, axis=0), np.max(his, axis=0)


class IntersectRegion(Region):
    """region intersect (src/region_intersect.cpp)."""

    def __init__(self, regions):
        self.regions = list(regions)

    def inside(self, pts):
        out = self.regions[0].inside(pts)
        for r in self.regions[1:]:
            out = out & r.inside(pts)
        return out

    def bounding_box(self):
        los, his = zip(*[r.bounding_box() for r in self.regions])
        return np.max(los, axis=0), np.min(his, axis=0)
