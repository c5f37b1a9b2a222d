"""Lattice definitions and lattice->box coordinate transform.

Reimplements the reference's Lattice (src/lattice.cpp) for the styles the
benchmark decks use (fcc/bcc/sc/hcp/diamond/sq/sq2/hex/custom, LJ reduced
density scaling).  The arithmetic mirrors Lattice::lattice2box
(src/lattice.cpp:469-485) exactly — positions feed the byte-level hash of
``velocity ... loop geom`` so the float64 operation order matters.
"""

from __future__ import annotations

import numpy as np

_BASES = {
    "none": np.zeros((1, 3)),
    "sc": np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]),
    "hcp": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 5.0 / 6.0, 0.5], [0.0, 1.0 / 3.0, 0.5]]),
    "diamond": np.array([
        [0.0, 0.0, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0],
        [0.25, 0.25, 0.25], [0.25, 0.75, 0.75],
        [0.75, 0.25, 0.75], [0.75, 0.75, 0.25]]),
    "sq": np.array([[0.0, 0.0, 0.0]]),
    "sq2": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
    "hex": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
}

_2D_STYLES = {"sq", "sq2", "hex"}


class Lattice:
    """A Bravais lattice with basis, scaled to box units."""

    def __init__(self, style: str, scale: float, units: str = "lj",
                 dimension: int = 3, args=()):
        if style != "custom" and style not in _BASES:
            raise ValueError(f"Unknown lattice style {style!r}")
        self.style = style
        dim = 2 if style in _2D_STYLES else dimension

        # primitive cell: unit cube, except hcp/hex stretch a2/a3
        self.a1 = np.array([1.0, 0.0, 0.0])
        self.a2 = np.array([0.0, 1.0, 0.0])
        self.a3 = np.array([0.0, 0.0, 1.0])
        if style == "hex":
            self.a2[1] = np.sqrt(3.0)
        if style == "hcp":
            self.a2[1] = np.sqrt(3.0)
            self.a3[2] = np.sqrt(8.0 / 3.0)

        self.origin = np.zeros(3)
        self._spacing_override = None
        if style == "custom":
            # lattice custom scale a1 x y z a2 ... a3 ... basis bx by bz
            # [basis ...] [origin ox oy oz] (src/lattice.cpp options)
            basis_rows = []
            toks = list(args)
            i = 0
            while i < len(toks):
                key = toks[i]
                if key in ("a1", "a2", "a3", "origin"):
                    vec = np.array([float(v) for v in toks[i + 1:i + 4]])
                    setattr(self, key if key != "origin" else "origin", vec)
                    i += 4
                elif key == "basis":
                    basis_rows.append([float(v) for v in toks[i + 1:i + 4]])
                    i += 4
                elif key == "spacing":
                    self._spacing_override = np.array(
                        [float(v) for v in toks[i + 1:i + 4]])
                    i += 4
                elif key in ("orient", "triclinic/general"):
                    # orient: only the identity orientation is supported
                    i += 5 if key == "orient" else 1
                else:
                    raise ValueError(f"lattice custom keyword {key!r}")
            if not basis_rows:
                raise ValueError("lattice custom requires at least one basis")
            self.basis = np.array(basis_rows)
        else:
            self.basis = _BASES[style].copy()
            # shared keyword parse for the standard styles
            toks = list(args)
            i = 0
            while i < len(toks):
                key = toks[i]
                if key == "origin":
                    self.origin = np.array(
                        [float(v) for v in toks[i + 1:i + 4]])
                    i += 4
                elif key == "spacing":
                    self._spacing_override = np.array(
                        [float(v) for v in toks[i + 1:i + 4]])
                    i += 4
                elif key == "orient":
                    i += 5
                else:
                    raise ValueError(f"lattice keyword {key!r} unsupported")

        nbasis = self.basis.shape[0]
        if units == "lj" and style != "none":
            # reduced density: spacing = (nbasis/volume/density)^(1/dim)
            # (src/lattice.cpp:262)
            volume = abs(np.linalg.det(np.stack([self.a1, self.a2, self.a3])))
            self.scale = (nbasis / volume / scale) ** (1.0 / dim)
        else:
            self.scale = scale

        # bounding-box extents of the scaled unit cell (xlattice etc.)
        corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                            for k in (0, 1)], dtype=np.float64)
        pts = corners @ np.stack([self.a1, self.a2, self.a3]) * self.scale
        self.spacing = pts.max(axis=0) - pts.min(axis=0)
        if style == "none":
            self.spacing = np.array([self.scale] * 3)
        if self._spacing_override is not None:
            self.spacing = self._spacing_override.copy()

    @property
    def nbasis(self) -> int:
        return self.basis.shape[0]

    def lattice2box(self, pts: np.ndarray) -> np.ndarray:
        """Map (N,3) lattice coords to box coords.

        Mirrors Lattice::lattice2box float64 op order: primitive matvec,
        then multiply by scale componentwise (origin assumed 0).
        """
        pts = np.asarray(pts, dtype=np.float64)
        if self.origin.any():
            pts = pts + self.origin
        x1 = self.a1[0] * pts[:, 0] + self.a2[0] * pts[:, 1] + self.a3[0] * pts[:, 2]
        y1 = self.a1[1] * pts[:, 0] + self.a2[1] * pts[:, 1] + self.a3[1] * pts[:, 2]
        z1 = self.a1[2] * pts[:, 0] + self.a2[2] * pts[:, 1] + self.a3[2] * pts[:, 2]
        return np.stack([x1 * self.scale, y1 * self.scale, z1 * self.scale], axis=1)
