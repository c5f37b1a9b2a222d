"""The layouts of a run decomposed over a mesh: the cell grid's bricks and
the matrix engine's row blocks.

tpumd shards the z-major slot arrays of its cell grid in blocks, which
makes a z-slab decomposition, and a (z, y) pencil one with more devices
than z-planes (tests/test_pencil_sharding.py); XLA turns the grid's rolls
into collective-permutes of one boundary plane.  The port lays the same
bricks out by hand (``GridLayout``):

* P ranks form a processor grid pz x py: z-slabs where P <= nz, else
  pencils with pz <= nz and py <= ny (``processor_grid``).  Each rank owns
  contiguous planes and rows, split at n k // p (uneven where p does not
  divide n).  An axis that one rank spans is not split: it keeps the
  grid's own periodic wrap and gets no halo, so a world of one is the
  one-card grid.
* A rank's local grid is its owned cells and one halo layer on each side
  of a split axis, edges and corners included.  A cell is at least
  cutneigh wide, so one layer holds every neighbour of an owned atom.
* A halo cell across a periodic seam holds its atoms' positions shifted by
  the box length (``slot_maps``' shift), as LAMMPS's ghost atoms do.  An
  owned cell's stencil then never wraps on a split axis, its list entries
  are the one-card list's entries in the stencil's order, and the sweeps'
  minimum image adds nothing to them: the kernels see the global periodic
  box, the list build and refresh the box with the split axes marked
  non-periodic (``GridLayout.list_box``).  Within a cell the atoms sit in
  the one-card grid's order (by index at set-up, by tag at a re-bin, as
  ``cellgrid.bin_compact`` places them).
* Forces are full-list sums over the owned rows only (the kernels'
  ``rows``), so nothing flows back from the halos.

``GridDecomp`` runs it over a mesh: the set-up's local grid assembled by
index from the replicated global grid, the per-step position exchange
(and EAM's F'(rho) between its two sweeps), and at each re-bin the
migration, the local binning and the halo slots' exchange; ``unshard``
gathers the owned atoms back into the one-card grid's slot order.
``RowDecomp`` is the matrix engine's: contiguous row blocks, the
positions all-gathered each step (tpumd's "replicated-position
all-gather" regime, tpumd/parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpumd_torch.core.state import MDState, map_per_atom
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.parallel.halo import GridHalo, column, migrate, \
    pack_rows, unpack_rows
from tpumd_torch.parallel.mesh import Mesh, block_bounds, pad_to_multiple


def processor_grid(nz: int, ny: int, nprocs: int) -> tuple[int, int]:
    """(pz, py) of nprocs ranks on a grid of nz planes and ny rows: z-slabs
    where nprocs <= nz, else the pencils of the most planes, pz <= nz,
    with py = nprocs / pz <= ny.  Raises where no such grid exists."""
    if nprocs < 1:
        raise ValueError(f"{nprocs} ranks")
    if nprocs <= nz:
        return nprocs, 1
    for pz in range(min(nz, nprocs), 0, -1):
        if nprocs % pz == 0 and nprocs // pz <= ny:
            return pz, nprocs // pz
    raise ValueError(
        f"{nprocs} ranks cannot be laid out on a cell grid of nz {nz} "
        f"planes and ny {ny} rows: a block is at least one plane and one "
        "row (pz <= nz, py <= ny, pz py = the world size)")


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """One rank's brick of the global grid cfg on a pz x py processor
    grid; rank = iz py + iy."""

    cfg: cg.CellGridConfig
    pz: int
    py: int
    rank: int

    def __post_init__(self):
        if not (1 <= self.pz <= self.cfg.nz and 1 <= self.py <= self.cfg.ny):
            raise ValueError(
                f"a {self.pz} x {self.py} processor grid on a cell grid of "
                f"nz {self.cfg.nz}, ny {self.cfg.ny}: a block is at least "
                "one plane and one row")
        if not 0 <= self.rank < self.pz * self.py:
            raise ValueError(f"rank {self.rank} of {self.pz * self.py}")

    @property
    def iz(self) -> int:
        return self.rank // self.py

    @property
    def iy(self) -> int:
        return self.rank % self.py

    @functools.cached_property
    def zb(self) -> np.ndarray:
        return block_bounds(self.cfg.nz, self.pz)

    @functools.cached_property
    def yb(self) -> np.ndarray:
        return block_bounds(self.cfg.ny, self.py)

    @property
    def hz(self) -> int:
        """Halo layers below the owned planes: 1 on a split z axis."""
        return int(self.pz > 1)

    @property
    def hy(self) -> int:
        return int(self.py > 1)

    def rank_of(self, iz: int, iy: int) -> int:
        return (iz % self.pz) * self.py + iy % self.py

    @property
    def zlo(self) -> int:
        return self.rank_of(self.iz - 1, self.iy)

    @property
    def zhi(self) -> int:
        return self.rank_of(self.iz + 1, self.iy)

    @property
    def ylo(self) -> int:
        return self.rank_of(self.iz, self.iy - 1)

    @property
    def yhi(self) -> int:
        return self.rank_of(self.iz, self.iy + 1)

    @functools.cached_property
    def local_cfg(self) -> cg.CellGridConfig:
        nz = int(self.zb[self.iz + 1] - self.zb[self.iz]) + 2 * self.hz
        ny = int(self.yb[self.iy + 1] - self.yb[self.iy]) + 2 * self.hy
        return dataclasses.replace(self.cfg, nz=nz, ny=ny)

    def list_box(self, box):
        """The box of the local grid's list build and refresh: a split axis
        is not periodic there (its halos carry the seam shift)."""
        split = (False, self.py > 1, self.pz > 1)
        periodic = tuple(bool(p) and not sp for p, sp in
                         zip(box.periodic, split))
        return box if periodic == box.periodic else box.replace(
            periodic=periodic)

    @functools.cached_property
    def cell_maps(self):
        """(global cell (ncl,), seam shift (ncl, 3) in box lengths, -1, 0
        or 1, owned (ncl,) bool) of each local cell, numpy."""
        lc, g = self.local_cfg, self.cfg
        lz, ly, lx = np.meshgrid(np.arange(lc.nz), np.arange(lc.ny),
                                 np.arange(lc.nx), indexing="ij")
        z = self.zb[self.iz] + lz - self.hz
        y = self.yb[self.iy] + ly - self.hy
        shift = np.stack([np.zeros_like(z), np.floor_divide(y, g.ny),
                          np.floor_divide(z, g.nz)], axis=-1)
        gcell = (np.mod(z, g.nz) * g.ny + np.mod(y, g.ny)) * g.nx + lx
        owned = ((lz >= self.hz) & (lz < lc.nz - self.hz)
                 & (ly >= self.hy) & (ly < lc.ny - self.hy))
        return gcell.reshape(-1), shift.reshape(-1, 3), owned.reshape(-1)

    @functools.cached_property
    def slot_maps(self):
        """(global slot (Np,), seam shift (Np, 3), owned (Np,)) of each
        local slot, numpy: slot k of a cell is slot k of its global cell."""
        gcell, shift, owned = self.cell_maps
        cap = self.cfg.cap
        k = np.arange(cap)
        return ((gcell[:, None] * cap + k[None]).reshape(-1),
                np.repeat(shift, cap, axis=0), np.repeat(owned, cap))

    @functools.cached_property
    def copies(self) -> int:
        """The most local cells that show one global cell: 2 a split axis
        of 2 blocks (the other block's boundary cells in both halos), 1
        elsewhere; the slots one tag may fill (ops/cellgrid_tuples.py)."""
        return int(np.bincount(self.cell_maps[0]).max())

    def blocks_of_cells(self, gz, gy):
        """(z block, y block) of global cell coordinates (torch)."""
        zb = torch.as_tensor(self.zb, device=gz.device)
        yb = torch.as_tensor(self.yb, device=gy.device)
        return (torch.searchsorted(zb, gz.to(zb.dtype), right=True) - 1,
                torch.searchsorted(yb, gy.to(yb.dtype), right=True) - 1)


def assemble_slots(layout: GridLayout, s: MDState, valid):
    """The local grid of layout taken by index from the global grid-ordered
    state s (every rank's grid, replicated) and its valid slots: the owned
    slots with every per-atom field, the halo slots with x (plus the seam
    shift), tag, type and q, their other fields 0.  Returns (local state,
    local valid)."""
    gslot, shift, owned = (torch.as_tensor(a, device=s.x.device)
                           for a in layout.slot_maps)

    def take(a):
        keep = owned.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(keep, a[gslot], torch.zeros((), dtype=a.dtype,
                                                       device=a.device))

    loc = map_per_atom(s, take)
    return loc.replace(x=s.x[gslot] + shift.to(s.x.dtype) * s.box.lengths,
                       tag=s.tag[gslot], type=s.type[gslot],
                       q=None if s.q is None else s.q[gslot]), valid[gslot]


class GridDecomp:
    """The cell grid cfg decomposed over a mesh (``GridLayout`` of this
    rank), with the tensors the run reads on the rank's device."""

    kind = "grid"

    def __init__(self, mesh: Mesh, cfg: cg.CellGridConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.layout = GridLayout(cfg, *processor_grid(cfg.nz, cfg.ny,
                                                      mesh.size), mesh.rank)
        self.local_cfg = self.layout.local_cfg
        gslot, shift, owned = self.layout.slot_maps
        dev = mesh.device
        self.gslot = torch.as_tensor(gslot, device=dev)
        self._shift = torch.as_tensor(shift, device=dev)
        self.owned_slot = torch.as_tensor(owned, device=dev)
        self.halo = GridHalo(self.layout, mesh)
        self._boxes = (None, None)

    def list_box(self, box):
        """``GridLayout.list_box`` of the step's box, made once a box."""
        if box is not self._boxes[0]:
            self._boxes = (box, self.layout.list_box(box))
        return self._boxes[1]

    def shift(self, box):
        """(Np, 3) each local slot's seam shift in x's units."""
        return self._shift.to(box.lengths.dtype) * box.lengths

    def owned(self, valid):
        return valid & self.owned_slot

    def shard(self, s: MDState, valid):
        """(local state, valid, owned) of the global grid-ordered state s
        (``assemble_slots``)."""
        loc, valid_l = assemble_slots(self.layout, s, valid)
        return loc, valid_l, self.owned(valid_l)

    def exchange_positions(self, x, box):
        """x with its halo slots refilled from the neighbours' owned
        cells, seam shift added (a new tensor)."""
        if not self._split:
            return x
        x = self.halo.fill(x.clone())
        return torch.where(self._halo_slot[:, None], x + self.shift(box), x)

    def exchange_vf(self, v, f):
        """(v, f) with their halo slots refilled from the owners (new
        tensors, one exchange round a split axis): the members' velocities
        and forces that SHAKE's tag-matched solve reads."""
        if not self._split:
            return v, f
        vf = self.halo.fill(torch.cat([v, f], dim=1))
        return vf[:, :3], vf[:, 3:]

    def exchange_fp(self, fp):
        """Per-slot values (EAM's F'(rho)) with the halo slots refilled (a
        new tensor); no shift."""
        if not self._split:
            return fp
        return self.halo.fill(fp.clone().reshape(-1, 1)).reshape(-1)

    @functools.cached_property
    def _split(self) -> bool:
        return self.layout.pz > 1 or self.layout.py > 1

    @functools.cached_property
    def _halo_slot(self):
        return ~self.owned_slot

    def _global_cells(self, x, box):
        """(gz, gy, cell id) of wrapped positions on the global grid, as
        ``cellgrid._cell_ids`` bins them."""
        cid = cg._cell_ids(x, box, self.cfg)
        gz = cid // (self.cfg.ny * self.cfg.nx)
        gy = (cid // self.cfg.nx) % self.cfg.ny
        return gz, gy, cid

    def rebin(self, s: MDState, rows):
        """The re-bin of the atoms in slots rows (this rank's owned ones,
        wrapped): migration to the blocks that own their cells, the local
        binning (in tag order within a cell, as ``cellgrid.bin_compact``)
        and the halo slots' exchange (positions, tags, types and charges).
        Returns (state, valid, owned, owned slots (n,) int64, max_count,
        overflow)."""
        lay, lc = self.layout, self.local_cfg
        box = s.box
        atoms = map_per_atom(s, lambda a: a[rows])
        if self._split:
            packed, spec = pack_rows(atoms)
            xcol, tcol = column(spec, "x"), column(spec, "tag")

            def block_of(p):
                gz, gy, _ = self._global_cells(p[:, xcol:xcol + 3].to(
                    s.x.dtype), box)
                return lay.blocks_of_cells(gz, gy)

            atoms = unpack_rows(migrate(lay, self.mesh, packed, block_of,
                                        tcol), spec, box)
        gz, gy, cid = self._global_cells(atoms.x, box)
        gx = cid % self.cfg.nx
        lz = gz - int(lay.zb[lay.iz]) + lay.hz
        ly = gy - int(lay.yb[lay.iy]) + lay.hy
        lcid = (lz * lc.ny + ly) * lc.nx + gx
        by_tag = torch.argsort(atoms.tag, stable=True)
        o2, dst, max_count, overflow = cg.cell_slots(lcid[by_tag], lc)
        order = by_tag[o2]
        loc = map_per_atom(atoms, lambda a: cg.move_rows(a, order, dst,
                                                         lc.capacity))
        if self._split:
            # the halo slots: positions, tags, types and charges from the
            # neighbours
            cols = [loc.x.to(torch.float64),
                    loc.tag.to(torch.float64)[:, None],
                    loc.type.to(torch.float64)[:, None]]
            if loc.q is not None:
                cols.append(loc.q.to(torch.float64)[:, None])
            halo = self.halo.fill(torch.cat(cols, dim=1))
            x = halo[:, :3].to(s.x.dtype)
            loc = loc.replace(x=torch.where(self._halo_slot[:, None],
                                            x + self.shift(box), x),
                              tag=halo[:, 3].to(loc.tag.dtype),
                              type=halo[:, 4].to(loc.type.dtype),
                              q=None if loc.q is None
                              else halo[:, 5].to(loc.q.dtype).contiguous())
        valid = loc.tag > 0
        owned = self.owned(valid)
        return (loc, valid, owned, torch.nonzero(owned).reshape(-1),
                max_count, overflow)

    def unshard(self, s: MDState, neigh) -> MDState:
        """The atoms of every rank's owned slots (neigh.row2slot), gathered
        in the one-card grid's slot order (its ``compact_state``): natoms
        rows on every rank."""
        rows = neigh.row2slot
        packed, spec = pack_rows(map_per_atom(s, lambda a: a[rows]))
        packed = torch.cat([self.gslot[rows].to(torch.float64)[:, None],
                            packed], dim=1)
        allp = torch.cat(self.mesh.all_gather_rows(packed))
        allp = allp[torch.argsort(allp[:, 0])]
        return unpack_rows(allp[:, 1:], spec, s.box)

    def thermo_view(self, s: MDState, neigh) -> MDState:
        """s with the halo slots' velocities and tags zeroed: the state
        whose sums are this rank's share of the thermo row."""
        own = neigh.owned
        return s.replace(v=torch.where(own[:, None], s.v, 0.0),
                         tag=torch.where(own, s.tag, 0))


class RowDecomp:
    """The matrix engine's rows in contiguous blocks over a mesh: the rank
    owns rows [r0, r1) of the natoms-row state; each force evaluation and
    re-bin reads every row's position (an all-gather, padded to the
    largest block) and the tags, types and charges of the set-up.  The
    bonded styles and SHAKE run on every row's view (``rows_view``) and
    keep the rank's rows' forces; their energies and virial, like kspace's
    of the whole mesh, count on rank 0 only (``once``)."""

    kind = "rows"

    def __init__(self, mesh: Mesh, natoms: int):
        self.mesh = mesh
        self.natoms = natoms
        self.bounds = block_bounds(natoms, mesh.size)
        self.r0 = int(self.bounds[mesh.rank])
        self.r1 = int(self.bounds[mesh.rank + 1])
        self.width = pad_to_multiple(natoms, mesh.size) // mesh.size
        # the gathered (size width) rows' real ones, in row order
        idx = np.concatenate([k * self.width + np.arange(
            self.bounds[k + 1] - self.bounds[k]) for k in range(mesh.size)])
        self._take = torch.as_tensor(idx, device=mesh.device)
        self.type_all = self.tag_all = self.q_all = None

    def shard(self, s: MDState, valid=None):
        """(the rank's rows of the natoms-row state s (replicated), None,
        None); the tags, types and charges of every row are kept for the
        j side."""
        self.type_all, self.tag_all, self.q_all = s.type, s.tag, s.q
        return map_per_atom(s, lambda a: a[self.r0:self.r1]), None, None

    def gather_rows(self, a):
        """(natoms, W) every rank's rows of a (n_r, W), in row order."""
        pad = a
        if a.shape[0] < self.width:
            pad = torch.cat([a, a.new_zeros((self.width - a.shape[0],)
                                            + tuple(a.shape[1:]))])
        out = self.mesh.all_gather_equal(pad)
        return out.index_select(0, self._take)

    def gather_x(self, x):
        """(natoms, 3) every row's position."""
        return self.gather_rows(x)

    def ext(self, s: MDState, xall=None):
        """The j-side tables of the rank's rows (``pair_sums``' ext), xall
        every row's positions where the caller has gathered them."""
        return (self.gather_x(s.x) if xall is None else xall, self.type_all,
                self.q_all, s.box)

    @functools.cached_property
    def rows_of_tag(self):
        """(natoms,) the row of each tag - 1 over every rank's rows."""
        return cg.row2slot_from_tags(self.tag_all, self.natoms)

    def once(self, value):
        """value on rank 0, zeros elsewhere: a sum that every rank computes
        whole and the thermo row's all-reduce must count once."""
        return value if self.mesh.rank == 0 else torch.zeros_like(value)

    def unshard(self, s: MDState, neigh=None) -> MDState:
        """Every rank's rows, in row order, on every rank."""
        packed, spec = pack_rows(s)
        return unpack_rows(torch.cat(self.mesh.all_gather_rows(packed)),
                           spec, s.box)

    def thermo_view(self, s: MDState, neigh) -> MDState:
        return s
