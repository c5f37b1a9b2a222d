"""Molecule template files: the ``molecule`` command (src/molecule.cpp).

The port of tpumd/io/molecule.py: the file's header counts and its Coords,
Types, Charges, Masses, Bonds, Angles, Dihedrals and Impropers sections
make a template that ``create_atoms ... mol`` places at each lattice site
with a random orientation.  The centre and the displacements from it
follow Molecule::compute_center (:185): a plain average, not weighted by
mass.  The placement helpers keep the reference's operation order
(math_extra.h), because ``velocity ... loop geom`` hashes the bytes of the
coordinates they give.
"""


from __future__ import annotations

import numpy as np


class MoleculeTemplate:
    def __init__(self, mol_id, path):
        self.id = mol_id
        self.natoms = 0
        self.x = None          # (n, 3)
        self.types = None      # (n,)
        self.q = None
        self.masses = None
        self.bonds = np.zeros((0, 3), np.int64)      # (type, a1, a2) 1-based
        self.angles = np.zeros((0, 4), np.int64)
        self.dihedrals = np.zeros((0, 5), np.int64)
        self.impropers = np.zeros((0, 5), np.int64)
        self._parse(path)
        # Molecule::compute_center (src/molecule.cpp:185-198): strict
        # sequential sum, then divide (numpy's unrolled mean rounds
        # differently and the difference is hash-visible downstream)
        c = np.zeros(3)
        for row in self.x:
            c = c + row
        self.center = c / self.natoms
        self.dx = self.x - self.center

    def _parse(self, path):
        with open(path) as fh:
            lines = [ln.split("#")[0].rstrip() for ln in fh]
        lines = lines[1:]  # title line
        counts = {}
        i = 0
        # header: "<int> <keyword...>" until the first section header
        while i < len(lines):
            ln = lines[i].strip()
            i += 1
            if not ln:
                continue
            parts = ln.split()
            if parts[0].lstrip("-").replace(".", "").isdigit():
                counts[" ".join(parts[1:])] = float(parts[0])
            else:
                i -= 1
                break
        self.natoms = int(counts.get("atoms", 0))
        n = self.natoms
        self.x = np.zeros((n, 3))
        self.types = np.ones(n, np.int64)

        def rows(count, width):
            nonlocal i
            out = []
            got = 0
            while i < len(lines) and got < count:
                ln = lines[i].strip()
                i += 1
                if not ln:
                    continue
                out.append([float(v) for v in ln.split()[:width]])
                got += 1
            return np.asarray(out)

        while i < len(lines):
            ln = lines[i].strip()
            i += 1
            if not ln:
                continue
            if ln == "Coords":
                r = rows(n, 4)
                self.x[r[:, 0].astype(int) - 1] = r[:, 1:4]
            elif ln == "Types":
                r = rows(n, 2)
                self.types[r[:, 0].astype(int) - 1] = r[:, 1].astype(int)
            elif ln == "Charges":
                r = rows(n, 2)
                self.q = np.zeros(n)
                self.q[r[:, 0].astype(int) - 1] = r[:, 1]
            elif ln == "Masses":
                r = rows(n, 2)
                self.masses = np.zeros(n)
                self.masses[r[:, 0].astype(int) - 1] = r[:, 1]
            elif ln == "Bonds":
                r = rows(int(counts.get("bonds", 0)), 4).astype(np.int64)
                self.bonds = r[:, 1:4]
            elif ln == "Angles":
                r = rows(int(counts.get("angles", 0)), 5).astype(np.int64)
                self.angles = r[:, 1:5]
            elif ln == "Dihedrals":
                r = rows(int(counts.get("dihedrals", 0)),
                         6).astype(np.int64)
                self.dihedrals = r[:, 1:6]
            elif ln == "Impropers":
                r = rows(int(counts.get("impropers", 0)),
                         6).astype(np.int64)
                self.impropers = r[:, 1:6]
            elif ln in ("Special Bond Counts", "Special Bonds"):
                # recomputed from the bond topology at insertion
                cnt = int(counts.get("atoms", 0))
                rows(cnt, 10)
            else:
                raise ValueError(f"molecule file section {ln!r} "
                                 "not supported")


def axisangle_to_quat(r, theta):
    """math_extra.h axisangle_to_quat: r must be normalized.  Uses
    libm sin/cos via the math module — numpy's SIMD routines differ by
    1 ulp for some arguments, which the coordinate hash downstream
    (velocity loop geom) amplifies into different RNG streams."""
    import math
    half = 0.5 * theta
    s = math.sin(half)
    return np.array([math.cos(half), r[0] * s, r[1] * s, r[2] * s])


def quat_to_mat_np(q):
    """MathExtra::quat_to_mat (src/math_extra.cpp:391-415) with the
    reference's exact product/sum order — the rotated coordinates feed
    `velocity loop geom`'s bit-sensitive coordinate hash."""
    w, i, j, k = q
    w2, i2, j2, k2 = w * w, i * i, j * j, k * k
    twoij = 2.0 * i * j
    twoik = 2.0 * i * k
    twojk = 2.0 * j * k
    twoiw = 2.0 * i * w
    twojw = 2.0 * j * w
    twokw = 2.0 * k * w
    return np.array([
        [w2 + i2 - j2 - k2, twoij - twokw, twojw + twoik],
        [twoij + twokw, w2 - i2 + j2 - k2, twojk - twoiw],
        [twoik - twojw, twojk + twoiw, w2 - i2 - j2 + k2]])


def norm3_np(v):
    """MathExtra::norm3 (src/math_extra.h:155): multiply by 1/sqrt —
    NOT a divide; the rounding difference is observable downstream."""
    val = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    if val > 0.0:
        return v * (1.0 / np.sqrt(val))
    return v


def rotate_place_np(dx, rotmat, center):
    """matvec + add3 per MathExtra (src/math_extra.h:483-488): explicit
    left-to-right sums, elementwise (no BLAS reassociation)."""
    out = np.empty_like(dx)
    for r in range(3):
        out[:, r] = (rotmat[r][0] * dx[:, 0] + rotmat[r][1] * dx[:, 1]
                     + rotmat[r][2] * dx[:, 2]) + center[r]
    return out
