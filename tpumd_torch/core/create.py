"""create_atoms: fill a region with lattice atoms (host-side, setup time).

Mirrors CreateAtoms::add_lattice (src/create_atoms.cpp:1294-1340): iterate
unit cells (k, j, i) with all basis atoms per cell, transform to box coords,
keep atoms that match the region and fall inside the box with
lower-inclusive / upper-exclusive ownership bounds.
"""

from __future__ import annotations

import numpy as np

from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.region import Region


def remap_host(x, lo, hi, periodic):
    """Domain::remap (src/domain.cpp:1232-1290) on host arrays, as
    tpumd/core/create.py has it: iterative +=/-= period loops (a
    floor-based single-shot wrap rounds differently for |shift| > 1), then
    the lo clamp.  Mutates x in place; returns the per-atom image
    offsets."""
    img = np.zeros(x.shape, np.int32)
    for c in range(3):
        if not periodic[c]:
            continue
        period = hi[c] - lo[c]
        while True:
            m = x[:, c] < lo[c]
            if not m.any():
                break
            x[m, c] += period
            img[m, c] -= 1
        while True:
            m = x[:, c] >= hi[c]
            if not m.any():
                break
            x[m, c] -= period
            img[m, c] += 1
        x[:, c] = np.maximum(x[:, c], lo[c])
    return img


def remap_triclinic_host(x, lo, hi, tilt, periodic):
    """Domain::remap of every atom in a triclinic box (host, float64), as
    tpumd/script/parser.py::_triclinic_remap_np has it: x to lamda in the
    reference's h_inv order, wrap into [0, 1) along periodic axes, back to
    x in its h order.  Returns (x, image offsets)."""
    x = np.asarray(x, np.float64)
    lo = np.asarray(lo, np.float64)
    lx, ly, lz = np.asarray(hi, np.float64) - lo
    xy, xz, yz = (float(t) for t in tilt)
    hinv = [1.0 / lx, 1.0 / ly, 1.0 / lz, -yz / (ly * lz),
            (yz * xy - ly * xz) / (lx * ly * lz), -xy / (lx * ly)]
    dd = x - lo
    lam = np.stack([hinv[0] * dd[:, 0] + hinv[5] * dd[:, 1]
                    + hinv[4] * dd[:, 2],
                    hinv[1] * dd[:, 1] + hinv[3] * dd[:, 2],
                    hinv[2] * dd[:, 2]], axis=1)
    shift = np.zeros(lam.shape, np.int32)
    for c in range(3):
        if periodic[c]:
            shift[:, c] = np.floor(lam[:, c]).astype(np.int32)
            lam[:, c] -= shift[:, c]
            lam[:, c] = np.maximum(lam[:, c], 0.0)
    out = np.stack([lx * lam[:, 0] + xy * lam[:, 1] + xz * lam[:, 2] + lo[0],
                    ly * lam[:, 1] + yz * lam[:, 2] + lo[1],
                    lz * lam[:, 2] + lo[2]], axis=1)
    return out, shift


def create_atoms_lattice(
    lattice: Lattice,
    region: Region | None,
    box_lo: np.ndarray,
    box_hi: np.ndarray,
    type_id: int = 1,
    fill_box: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (positions (N,3) float64, types (N,) int32) in creation order."""
    box_lo = np.asarray(box_lo, dtype=np.float64)
    box_hi = np.asarray(box_hi, dtype=np.float64)

    # loop bounds: lattice-space bounding box of the target volume
    if region is not None and not fill_box:
        tlo, thi = region.bounding_box()
        tlo = np.maximum(tlo, box_lo)
        thi = np.minimum(thi, box_hi)
    else:
        tlo, thi = box_lo, box_hi
    lat_lo = tlo / lattice.scale
    lat_hi = thi / lattice.scale
    ilo = np.floor(lat_lo).astype(int) - 1
    ihi = np.floor(lat_hi).astype(int) + 1

    ks = np.arange(ilo[2], ihi[2] + 1)
    js = np.arange(ilo[1], ihi[1] + 1)
    is_ = np.arange(ilo[0], ihi[0] + 1)
    nb = lattice.nbasis
    # (k, j, i, m) nesting with m fastest, matching the reference loop order
    kk, jj, ii, mm = np.meshgrid(ks, js, is_, np.arange(nb), indexing="ij")
    cells = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1).astype(np.float64)
    basis = lattice.basis[mm.ravel()]
    pts = lattice.lattice2box(cells + basis)

    keep = np.all((pts >= box_lo) & (pts < box_hi), axis=1)
    if region is not None:
        keep &= region.inside(pts)
    pts = pts[keep]
    types = np.full(pts.shape[0], type_id, dtype=np.int32)
    return pts, types
