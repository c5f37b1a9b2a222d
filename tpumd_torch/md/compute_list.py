"""Occasional neighbor lists of the distance computes, on the device.

LAMMPS's distance computes (rdf, coord/atom, cluster/atom, cna/atom,
centro/atom, orientorder/atom, group/group) request an occasional full
neighbor list at their own cutoff.  tpumd swept all pairs on the host
instead (tpumd/md/compute_pair.py::_pair_sweep, compute_struct.py::
_adjacency, "fixture scale"); the port builds the list on the device as
LAMMPS does, once per output state for the largest cutoff the deck's
distance computes ask for, and each compute keeps the pairs within its
own cutoff:

- on the cell grid, the list kernel (``ops/cellgrid_pairlist.py``, the
  same build that serves the force styles) at that cutoff over the run's
  standing bins, where every cell is at least the cutoff plus twice the
  largest displacement since the atoms were binned wide (then every pair
  within the cutoff now sits in neighbouring cells);
- otherwise, and on the matrix engine, the matrix engine's build
  (``ops/neighbor.py::build_neighbors``, its row gathers P1) on the atoms
  in tag order.

``pair_edges_plain`` is the plain version the computes are held to: a
chunked all-pairs sweep (tpumd's).  Both give the same ``Edges``: every
ordered pair (i, j), i != j, of atoms in tag order within the cutoff,
sorted by i then j, with d = x_i - x_j at the minimum image (float64,
rounded as tpumd rounds it) and r2 = |d|^2.  A box narrower than twice
the cutoff, which needs more than the nearest image, raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpumd_torch.md import peratom as pa
from tpumd_torch.ops import cellgrid_pairlist as cpl
from tpumd_torch.ops import neighbor as nb
from tpumd_torch.ops.cellgrid import pairlist_kmax

# the list is built this much beyond the cutoff, then cut in float64: an
# f32 build could drop a pair just inside it
MARGIN = 1.0e-5


class Edges(NamedTuple):
    i: torch.Tensor      # (E,) int64 tag-order index
    j: torch.Tensor      # (E,) int64
    d: torch.Tensor      # (E, 3) float64 x_i - x_j, minimum image
    r2: torch.Tensor     # (E,) float64
    n: int               # atoms

    def within(self, cutoff: float) -> "Edges":
        keep = self.r2 < cutoff * cutoff
        return Edges(self.i[keep], self.j[keep], self.d[keep],
                     self.r2[keep], self.n)


def list_cutoff(sim) -> float:
    """The largest cutoff among the deck's distance computes."""
    cuts = [c.list_cutoff(sim) for c in sim.computes.values()
            if hasattr(c, "list_cutoff")]
    return max(cuts) if cuts else 0.0


def _finish(a, i, j, cutoff):
    """Edges of index pairs (any order, within cutoff + margin) in float64,
    cut at the cutoff and sorted by (i, j)."""
    d = pa.min_image(a.x[i] - a.x[j], a)
    r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    keep = r2 < cutoff * cutoff
    i, j, d, r2 = i[keep], j[keep], d[keep], r2[keep]
    order = torch.argsort(i * a.n + j)
    return Edges(i[order], j[order], d[order], r2[order], a.n)


def _check_box(a, cutoff):
    ell = a.lengths.cpu().numpy()
    per = np.asarray(a.periodic)
    if (per & (ell < 2.0 * cutoff)).any():
        raise NotImplementedError(
            f"a distance compute at cutoff {cutoff} in a box of lengths "
            f"{ell}: more than the nearest periodic image is not ported")


def pair_edges(sim, cutoff: float) -> Edges:
    """The Edges of the current state within cutoff, from the output
    state's one device list (at ``list_cutoff``)."""
    rc = max(cutoff, list_cutoff(sim))
    full = pa.cached(sim, ("edges", rc), lambda: _build(sim, rc))
    return full if cutoff >= rc else full.within(cutoff)


def _build(sim, cutoff):
    a = pa.atoms(sim)
    _check_box(a, cutoff)
    sim.analysis_lists += 1
    s, neigh = pa.current(sim)
    ctx = sim._ctx
    if ctx is not None and ctx.is_cellgrid:
        out = _grid_list(sim, s, neigh, ctx.neigh_cfg, cutoff)
        if out is not None:
            return _finish(a, *out, cutoff)
    return _finish(a, *_matrix_list(sim, a, cutoff), cutoff)


def _grid_list(sim, s, neigh, cfg, cutoff):
    """(i, j) tag-order pairs from the list kernel over the run's bins, or
    None where the cells are too narrow for the cutoff now."""
    valid = neigh.valid
    disp = pa.min_image((s.x - neigh.xhold).double(), pa.atoms(sim))
    dmax = float(torch.sqrt(torch.max(torch.where(
        valid, (disp * disp).sum(1), 0.0))))
    ell = s.box.lengths_np()
    width = min(ell / np.array([cfg.nx, cfg.ny, cfg.nz]))
    rc = cutoff * (1.0 + MARGIN)
    if width < rc + 2.0 * dmax:
        return None
    lcfg = dataclasses.replace(cfg, cutneigh=rc, skin=0.0)
    k = pairlist_kmax(s.box, rc, sim.natoms)
    while True:
        pairs, npairs, longest, over = cpl.cellgrid_pairlist(
            s.x, valid, s.tag, None, None, s.box, lcfg, k)
        sim.analysis_grid_lists += 1
        if not bool(over):
            break
        k = int(np.ceil(int(longest) * 1.2 / 8) * 8)
    kk = max(int(npairs.max()), 1)
    live = (torch.arange(kk, device=s.x.device)[None, :]
            < npairs[:, None].long())
    si, col = torch.nonzero(live, as_tuple=True)
    sj = cpl.unpack(pairs[:, :kk])[0][si, col].long()
    pos = torch.full((s.x.shape[0],), -1, dtype=torch.int64,
                     device=s.x.device)
    pos[pa.tag_rows(sim)] = torch.arange(sim.natoms, device=s.x.device)
    return pos[si], pos[sj]


def _matrix_list(sim, a, cutoff):
    """(i, j) tag-order pairs from the matrix engine's build on the atoms
    in tag order."""
    rc = cutoff * (1.0 + MARGIN)
    s, _ = pa.current(sim)
    x = a.x.to(s.x.dtype)
    box = s.box
    lo = box.lo.to(x.dtype)
    per = torch.tensor(box.periodic, device=x.device)
    rel = torch.floor((x - lo) / box.lengths)
    x = torch.where(per, x - rel * box.lengths, x)
    cfg = nb.choose_config(box, rc, 0.0, a.n)
    while True:
        idx, _, most, over = nb.build_neighbors(x, box, cfg)
        if not bool(over):
            break
        cfg = dataclasses.replace(
            cfg, kmax=int(max(cfg.kmax * 1.5, int(most) * 1.3) + 8),
            cell_cap=int(np.ceil(cfg.cell_cap * 1.5 / 8) * 8))
    own = torch.arange(a.n, device=x.device)[:, None]
    i, col = torch.nonzero(idx != own, as_tuple=True)
    return i, idx[i, col].long()


def pair_edges_plain(sim, cutoff: float, chunk: int = 1024) -> Edges:
    """The plain version: every pair by a chunked all-pairs sweep in
    float64 (tpumd's _pair_sweep and _adjacency)."""
    a = pa.atoms(sim)
    _check_box(a, cutoff)
    c2 = cutoff * cutoff
    parts = []
    for i0 in range(0, a.n, chunk):
        d = pa.min_image(a.x[i0:i0 + chunk, None, :] - a.x[None, :, :], a)
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        rows = torch.arange(i0, i0 + d.shape[0], device=a.x.device)
        hit = r2 < c2
        hit[torch.arange(d.shape[0], device=a.x.device), rows] = False
        ii, jj = torch.nonzero(hit, as_tuple=True)
        parts.append((rows[ii], jj, d[ii, jj], r2[ii, jj]))
    i, j, d, r2 = (torch.cat(p) for p in zip(*parts))
    return Edges(i, j, d, r2, a.n)


def neighbor_table(e: Edges, width: int | None = None):
    """(table (n, W) int64 of each atom's neighbours in edge order, -1
    past its count; count (n,)) with W the largest count (or width)."""
    count = torch.bincount(e.i, minlength=e.n)
    w = width if width is not None else max(int(count.max()), 1) \
        if e.i.numel() else 1
    start = torch.cumsum(count, 0) - count
    col = torch.arange(e.i.numel(), device=e.i.device) - start[e.i]
    table = torch.full((e.n, w), -1, dtype=torch.int64, device=e.i.device)
    keep = col < w
    table[e.i[keep], col[keep]] = e.j[keep]
    return table, count, col
