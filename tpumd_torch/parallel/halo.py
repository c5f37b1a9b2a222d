"""Halo planes and atom migration of the decomposed cell grid.

The counterpart of the reference's ghost exchange (src/comm_brick.cpp
``borders``, ``forward_comm`` and ``exchange``) on the port's local grids
(``parallel/decomp.py``): each rank holds its owned cells and one layer of
halo cells on each side of a split axis.

* ``GridHalo.fill`` copies the boundary planes of the owned cells into the
  neighbours' halo planes: one round of ``batch_isend_irecv`` to the z
  neighbours, then one to the y neighbours, whose rows span the local z
  extent, z halos included, so that the edge and corner cells of a pencil
  arrive forwarded.  The data move as they are; the caller adds each halo
  cell's seam shift (``GridLayout.slot_maps``), so that no datum is
  shifted twice.
* ``migrate`` sends the atoms whose cell left the block to the rank that
  owns it, in the same two stages (an atom bound for a diagonal neighbour
  is forwarded by the rank it reaches first); an atom bound further raises,
  naming its tag.
* ``pack_rows`` / ``unpack_rows`` carry every per-atom field of an
  ``MDState`` as float64 columns (int32 tags and types and float32
  positions are exact in float64), one message a neighbour.
"""

from __future__ import annotations

import math

import torch

from tpumd_torch.core.state import PER_ATOM_FIELDS, MDState

# message tags: toward the lower neighbour, toward the upper one
DOWN, UP = 0, 1


def pack_rows(s: MDState):
    """(rows (n, W) float64 of every per-atom field of s, the layout
    [(name, tail shape, dtype)] that ``unpack_rows`` reads)."""
    cols, spec = [], []
    fields = [(k, getattr(s, k)) for k in PER_ATOM_FIELDS
              if getattr(s, k) is not None]
    fields += [(("peratom", k), a) for k, a in (s.peratom or {}).items()]
    n = s.x.shape[0]
    for name, a in fields:
        spec.append((name, tuple(a.shape[1:]), a.dtype))
        cols.append(a.reshape(n, -1).to(torch.float64))
    return torch.cat(cols, dim=1), spec


def column(spec, name: str) -> int:
    """The first column of field name in packed rows of layout spec."""
    c = 0
    for field, tail, _ in spec:
        if field == name:
            return c
        c += math.prod(tail)
    raise KeyError(name)


def unpack_rows(rows, spec, box) -> MDState:
    """The MDState of packed rows (``pack_rows``' layout) in box."""
    out, peratom, c = {}, {}, 0
    n = rows.shape[0]
    for name, tail, dtype in spec:
        w = math.prod(tail)
        a = rows[:, c:c + w].to(dtype).reshape((n,) + tail)
        c += w
        if isinstance(name, tuple):
            peratom[name[1]] = a
        else:
            out[name] = a
    return MDState(box=box, peratom=peratom or None, **out)


class GridHalo:
    """The halo-plane exchange of one rank's local grid (a GridLayout)
    over a mesh."""

    def __init__(self, layout, mesh):
        self.layout = layout
        self.mesh = mesh

    def fill(self, a):
        """a (Np_local, W) (or (Np_local,)) with its halo planes
        overwritten, in place, by the neighbours' boundary planes: z, then
        y.  Returns a."""
        lay = self.layout
        cfg = lay.local_cfg
        g = a.view(cfg.nz, cfg.ny, cfg.nx, cfg.cap, -1)
        if lay.pz > 1:
            self._axis(g, 0, lay.zlo, lay.zhi)
        if lay.py > 1:
            self._axis(g, 1, lay.ylo, lay.yhi)
        return a

    def _axis(self, g, axis: int, lo: int, hi: int):
        n = g.shape[axis]
        first = g.select(axis, 1).contiguous()
        last = g.select(axis, n - 2).contiguous()
        from_hi = torch.empty_like(first)
        from_lo = torch.empty_like(last)
        # the upper neighbour's first owned plane is this rank's upper
        # halo, the lower neighbour's last owned plane its lower halo
        self.mesh.exchange([(lo, first, DOWN), (hi, last, UP)],
                           [(hi, from_hi, DOWN), (lo, from_lo, UP)])
        g.select(axis, 0).copy_(from_lo)
        g.select(axis, n - 1).copy_(from_hi)


def _send_both(mesh, lo: int, hi: int, down, up):
    """One round of rows to the lower (down) and upper (up) neighbours:
    their counts, then the rows (one zero row appended to each message,
    so that none is empty).  Returns (rows from the lower neighbour, rows
    from the upper one)."""
    dev = down.device
    n_down = torch.tensor([down.shape[0]], dtype=torch.int64, device=dev)
    n_up = torch.tensor([up.shape[0]], dtype=torch.int64, device=dev)
    c_hi, c_lo = torch.empty_like(n_down), torch.empty_like(n_up)
    mesh.exchange([(lo, n_down, DOWN), (hi, n_up, UP)],
                  [(hi, c_hi, DOWN), (lo, c_lo, UP)])
    w = down.shape[1]
    pad = torch.zeros((1, w), dtype=down.dtype, device=dev)
    r_hi = torch.empty((int(c_hi[0]) + 1, w), dtype=down.dtype, device=dev)
    r_lo = torch.empty((int(c_lo[0]) + 1, w), dtype=down.dtype, device=dev)
    mesh.exchange([(lo, torch.cat([down, pad]), DOWN),
                   (hi, torch.cat([up, pad]), UP)],
                  [(hi, r_hi, DOWN), (lo, r_lo, UP)])
    return r_lo[:-1], r_hi[:-1]


def migrate(layout, mesh, rows, block_of, tag_col: int):
    """The packed rows (n, W) of this rank's atoms after a re-bin's
    migration: each row whose block (``block_of(rows)`` -> (z block, y
    block) (n,) each) is not this rank's is sent toward it, z first, then
    y, and the arrivals appended.  An atom bound past a neighbouring block
    raises, naming its tag (column tag_col)."""
    lay = layout
    for axis, parts, mine, lo, hi in ((0, lay.pz, lay.iz, lay.zlo, lay.zhi),
                                      (1, lay.py, lay.iy, lay.ylo, lay.yhi)):
        if parts == 1:
            continue
        d = (block_of(rows)[axis] - mine) % parts
        up = d == 1
        down = (d == parts - 1) & ~up
        far = (d != 0) & ~up & ~down
        if bool(far.any()):
            tags = rows[far, tag_col].to(torch.int64)[:8].tolist()
            raise RuntimeError(
                f"atoms {tags} moved past the neighbouring block along "
                f"{'zy'[axis]} since the last re-bin: an atom moves at most "
                "one cell between re-bins")
        from_lo, from_hi = _send_both(mesh, lo, hi, rows[down], rows[up])
        rows = torch.cat([rows[d == 0], from_lo, from_hi])
    zb, yb = block_of(rows)
    stray = (zb != lay.iz) | (yb != lay.iy)
    if bool(stray.any()):
        tags = rows[stray, tag_col].to(torch.int64)[:8].tolist()
        raise RuntimeError(f"atoms {tags} did not reach the block that owns "
                           "their cell")
    return rows
