"""Cell-grid neighbor structure: atoms stored in cell order.

PyTorch counterpart of tpumd/ops/cellgrid.py.  Atoms sit in a dense
(nz, ny, nx, cap) grid of fixed-capacity cells; forces are summed, per
atom, over the 27-cell stencil with no Newton's-third-law scatter.  A
rebuild re-bins the atoms (a permutation of the per-atom arrays into
grid-slot order) on the neighbor every/delay/check schedule; between
rebuilds the candidate set is a superset of the reference's frozen Verlet
list (src/npair_half_bin_newton.cpp).

The slot order is part of the contract: both sorts are stable, so the
port places every atom in the same slot as tpumd does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpumd_torch.core.state import Box, MDState, map_per_atom, \
    minimum_image


@dataclasses.dataclass(frozen=True)
class CellGridConfig:
    cutneigh: float
    skin: float
    nx: int
    ny: int
    nz: int
    cap: int                 # atoms per cell (padded capacity)
    every: int = 1
    delay: int = 0
    check: bool = True

    @property
    def ncells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def capacity(self) -> int:
        return self.ncells * self.cap


@dataclasses.dataclass(frozen=True)
class CellGridState:
    valid: torch.Tensor      # (Np,) bool: slot holds a real atom
    xhold: torch.Tensor      # (Np, 3) positions at last build
    ago: int                 # steps since the last build (host schedule)
    nbuilds: int
    overflow: torch.Tensor   # () bool, OR-accumulated over rebuilds
    max_count: torch.Tensor  # () most atoms seen in one cell
    row2slot: torch.Tensor   # (natoms,) tag -> slot map
    # granular styles: each slot's compact tag-keyed contact history
    # (ops/cellgrid_gran.py), per atom, so a re-bin moves it with the
    # atoms: partner tags (Np, KH) int32 (0 = empty) and shear (Np, KH, 3)
    shear_tags: torch.Tensor | None = None
    shear: torch.Tensor | None = None
    # the pair list every style on the grid sweeps
    # (ops/cellgrid_pairlist.py): the list of the last re-bin or refresh,
    # (Np, K) packed entries and (Np,) row counts, its (4,) int32 status
    # words (longest row, overflow, refreshes, gate stamp) kept over the
    # grid's re-bins, the longest row seen, () int (a view of the first
    # word), and, under a fix that moves the box, the box corners at the
    # re-bin, (3,) each, for the rebuild check; with FENE bonds in the pair
    # kernel, each slot's bond partners' slots (Np, nb) int32 (-1: none),
    # mapped at the same re-bin.  Where the schedule leaves steps
    # unchecked, the ListHold the refresh reads, and whether a refresh was
    # launched since the re-bin (on the host; the list then no longer
    # holds xhold's positions)
    pairs: torch.Tensor | None = None
    npairs: torch.Tensor | None = None
    list_stat: torch.Tensor | None = None
    max_pairs: torch.Tensor | None = None
    lohold: torch.Tensor | None = None
    hihold: torch.Tensor | None = None
    bond_slots: torch.Tensor | None = None
    list_hold: tuple | None = None
    list_gated: bool = False
    # on a rank's local grid (parallel/decomp.py): the valid slots of the
    # owned cells, whose rows the sweeps take (row2slot then holds their
    # slots); None on one card
    owned: torch.Tensor | None = None
    # () bool: some tuple of the tag-matched bonded path
    # (ops/cellgrid_tuples.py) lacked a member since the set-up (the
    # segment's flag read raises on it); None without that path
    tuples_missing: torch.Tensor | None = None

    def replace(self, **kw) -> "CellGridState":
        return dataclasses.replace(self, **kw)

    @property
    def any_overflow(self) -> torch.Tensor:
        """The overflow flag, with a refresh's row overflow since the
        re-bin where the list is refreshed."""
        if self.list_hold is None:
            return self.overflow
        return self.overflow | (self.list_stat[1] != 0)


def choose_cellgrid_config(box: Box, cutneigh: float, skin: float,
                           natoms: int, *, every=1, delay=0, check=True,
                           cap: int | None = None,
                           box_margin: float = 1.0) -> CellGridConfig:
    ell = box.lengths_np()
    if (ell < 2.0 * cutneigh).any():
        raise ValueError(
            f"box lengths {ell} must be >= 2*cutneigh ({2 * cutneigh:.3f})")
    nx, ny, nz = [max(1, int(np.floor(L / (cutneigh * box_margin))))
                  for L in ell]
    if cap is None:
        mean = natoms / (nx * ny * nz)
        cap = int(np.ceil((mean * 1.45 + 4) / 4) * 4)
    return CellGridConfig(cutneigh=float(cutneigh), skin=float(skin),
                          nx=nx, ny=ny, nz=nz, cap=int(cap),
                          every=every, delay=delay, check=check)


def pairlist_kmax(box: Box, cutneigh: float, natoms: int) -> int:
    """Row width of a pair list at cutneigh from the mean density, as the
    matrix engine sizes its K (ops/neighbor.py::choose_config): 35 % over
    the mean neighbour count, plus 4, a multiple of 4."""
    density = natoms / float(np.prod(box.lengths_np()))
    mean = density * 4.0 / 3.0 * np.pi * cutneigh ** 3
    return int(np.ceil((mean * 1.35 + 4) / 4) * 4)


def _cell_ids(x, box: Box, cfg: CellGridConfig):
    """Linear cell id of each position (x must be wrapped)."""
    dims = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.int32,
                        device=x.device)
    rel = (x - box.lo) / box.lengths * dims
    ci = torch.minimum(torch.clamp(torch.floor(rel).to(torch.int32), min=0),
                       dims - 1)
    return (ci[:, 2] * cfg.ny + ci[:, 1]) * cfg.nx + ci[:, 0]


def _set_drop(size: int, idx, values, fill=0):
    """out[idx] = values for idx < size; idx == size is dropped (the
    counterpart of JAX's scatter mode="drop")."""
    out = torch.full((size + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:size]


def bin_permutation(x, valid, box: Box, cfg: CellGridConfig):
    """Permutation taking atoms into grid-slot order.

    Returns (perm (Np,) atom index per slot or -1, valid_new, max_count,
    overflow).  Np = cfg.capacity; x must be wrapped.
    """
    npad = cfg.capacity
    cid = torch.where(valid, _cell_ids(x, box, cfg), cfg.ncells)
    sorted_cid, order = torch.sort(cid, stable=True)
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(x.shape[0], device=x.device) - first
    real = sorted_cid < cfg.ncells
    max_count = torch.max(torch.where(real, rank, -1)) + 1
    overflow = max_count > cfg.cap
    ok = real & (rank < cfg.cap)
    slot = torch.where(ok, sorted_cid * cfg.cap
                       + torch.clamp(rank, max=cfg.cap - 1), npad)
    perm = _set_drop(npad, slot, order, fill=-1)
    return perm, perm >= 0, max_count, overflow


def apply_permutation(state: MDState, perm, valid_new) -> MDState:
    """Reorder all per-atom arrays into grid-slot order (empty slots 0)."""
    idx = torch.clamp(perm, min=0)

    def take(a):
        keep = valid_new.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(keep, a[idx], torch.zeros((), dtype=a.dtype,
                                                     device=a.device))

    return map_per_atom(state, take)


def row2slot_from_tags(tag, natoms: int):
    """(natoms,) tag->slot map from the slot-ordered tag array."""
    target = torch.where(tag > 0, tag.long() - 1, natoms)
    return _set_drop(natoms, target,
                     torch.arange(tag.shape[0], device=tag.device))


def cell_slots(cid, cfg: CellGridConfig):
    """The slots of atoms with cell ids cid (n,), ties within a cell in
    the order given: one stable sort by cell id.  Returns (order (n,),
    dst (n,) the slot of atom order[k], or capacity where its cell is
    full, max_count, overflow).  ``bin_compact`` places the one-card
    grid's atoms with it, ``GridDecomp.rebin`` a rank's local grid's."""
    n = cid.shape[0]
    sorted_cid, order = torch.sort(cid, stable=True)
    iota = torch.arange(n, device=cid.device)
    newseg = torch.ones(n, dtype=torch.bool, device=cid.device)
    newseg[1:] = sorted_cid[1:] != sorted_cid[:-1]
    first = torch.cummax(torch.where(newseg, iota, 0), dim=0).values
    rank = iota - first
    max_count = (torch.max(rank) + 1 if n else
                 torch.zeros((), dtype=torch.int64, device=cid.device))
    overflow = max_count > cfg.cap
    dst = torch.where(rank < cfg.cap,
                      sorted_cid * cfg.cap
                      + torch.clamp(rank, max=cfg.cap - 1), cfg.capacity)
    return order, dst, max_count, overflow


def bin_compact(x, tag, natoms: int, box: Box, cfg: CellGridConfig,
                row2slot=None):
    """Re-bin the ``natoms`` real atoms: one stable sort by cell id with
    the source slot and the tag index as payload.

    Returns (src (n,) source slot per placement, dst (n,) destination slot
    or capacity for overflow-dropped atoms, row2slot_new, max_count,
    overflow).
    """
    npad = cfg.capacity
    n = natoms
    if row2slot is None:
        row2slot = row2slot_from_tags(tag, n)
    cid = _cell_ids(x[row2slot], box, cfg)
    order, dst, max_count, overflow = cell_slots(cid, cfg)
    src = row2slot[order]
    row2slot_new = torch.empty_like(row2slot)
    row2slot_new[order] = torch.clamp(dst, max=npad - 1).to(row2slot.dtype)
    return src, dst, row2slot_new, max_count, overflow


def move_rows(a, src, dst, capacity: int):
    """a's rows moved by bin_compact's (src, dst): an n-sized gather +
    scatter (empty slots zeroed; dst == capacity drops an overflowed
    atom)."""
    return _set_drop(capacity, dst, a[src])


def apply_permutation_compact(state: MDState, src, dst,
                              capacity: int) -> MDState:
    """Reorder per-atom arrays via move_rows."""
    return map_per_atom(state, lambda a: move_rows(a, src, dst, capacity))


def pad_rows(a, capacity: int):
    """a with zero rows appended up to capacity rows."""
    extra = capacity - a.shape[0]
    if extra < 0:
        raise ValueError("capacity smaller than atom count")
    return torch.cat([a, torch.zeros((extra,) + tuple(a.shape[1:]),
                                     dtype=a.dtype, device=a.device)])


def pad_state(state: MDState, capacity: int) -> MDState:
    """Pad per-atom arrays to the grid capacity (invalid slots at the end)."""
    return map_per_atom(state, lambda a: pad_rows(a, capacity))


def compact_rows(valid, natoms: int):
    """Indices of the valid slots, in slot order, truncated to natoms."""
    return torch.argsort((~valid).to(torch.int8), stable=True)[:natoms]


def compact_state(state: MDState, valid, natoms: int) -> MDState:
    """Gather valid atoms to the front and truncate to natoms rows."""
    idx = compact_rows(valid, natoms)
    return map_per_atom(state, lambda a: a[idx])


def displacement_exceeded(x, xhold, valid, box: Box, skin: float,
                          lohold=None, hihold=None):
    """Whether an atom moved more than half the skin since the build.
    Given the box corners at the build (a carried pair list, which the
    sweep does not re-test), the trigger shrinks by how far the corners
    moved, as Neighbor::check_distance does when a fix changes the box
    (src/neighbor.cpp): an image pair's separation changes by
    both atoms' moves and the box's."""
    d = minimum_image(x - xhold, box)
    rsq = torch.where(valid, torch.sum(d * d, dim=-1), 0)
    delta = 0.5 * skin
    if lohold is not None:
        moved = (torch.linalg.vector_norm(box.lo - lohold)
                 + torch.linalg.vector_norm(box.hi - hihold))
        delta = torch.clamp(0.5 * (skin - moved), min=0.0)
    return torch.max(rsq) > delta * delta


def _offs(n: int, periodic: bool = True):
    """Stencil offsets along one axis (tpumd/ops/cellgrid.py::_offs).

    Periodic axes always take all three: with n == 2 the +-1 neighbours
    are the same cell under DIFFERENT wrap corrections (direct and wrapped
    image), and with n == 1 they are the +-L periodic images of the self
    cell.  Valid because every config guards L >= 2*cutneigh, so at most
    one image of any pair is in range.  A non-periodic axis takes no wrap
    correction, so offsets that alias mod n are dropped: they would
    present the same atoms at the same coordinates twice (n == 2) or
    three times (n == 1).
    """
    if periodic or n >= 3:
        return (-1, 0, 1)
    return (-1, 0) if n == 2 else (0,)


def _roll_nbr(a, o: int, axis: int, corr):
    """Grid content of the neighbour cell at offset +o along axis; corr
    (a box length, or None) is added/subtracted where the periodic wrap
    crossed the box face."""
    r = torch.roll(a, -o, dims=axis)
    if o == 0 or corr is None:
        return r
    n = a.shape[axis]
    idx = torch.arange(n, device=a.device)
    step = ((idx + o >= n).to(a.dtype) - (idx + o < 0).to(a.dtype))
    shape = [1] * a.dim()
    shape[axis] = n
    return r + step.reshape(shape) * corr


def _cell_chunks(cfg: CellGridConfig, max_pairs):
    """(z, y, x) slices of i cells whose pair blocks (cap x 9 cap each)
    hold at most max_pairs pairs, or one cell when even a row is larger:
    the whole grid, z planes, (z, y) rows or single cells."""
    per_cell = 9 * cfg.cap * cfg.cap
    nz, ny, nx = cfg.nz, cfg.ny, cfg.nx
    every = slice(None)
    if max_pairs is None or cfg.ncells * per_cell <= max_pairs:
        return [(every, every, every)]
    if ny * nx * per_cell <= max_pairs:
        return [(slice(z, z + 1), every, every) for z in range(nz)]
    if nx * per_cell <= max_pairs:
        return [(slice(z, z + 1), slice(y, y + 1), every)
                for z in range(nz) for y in range(ny)]
    return [(slice(z, z + 1), slice(y, y + 1), slice(xi, xi + 1))
            for z in range(nz) for y in range(ny) for xi in range(nx)]


def stencil_blocks(x, valid, box: Box, cfg: CellGridConfig, per_slot=(),
                   max_pairs=None):
    """The candidate pairs of the plain sweeps, one z offset at a time.

    The x and y stencil offsets are folded into one 9*cap-wide j-row, so
    each block is (bz, by, bx, cap, 9 cap) for a chunk of i cells: the
    whole grid, or with max_pairs chunks of at most that many pairs (z
    planes, rows or cells), which bounds the sweep's memory.  Yields (sl,
    d, r2, mask, pairs): sl the (z, y, x) slices of the chunk's i cells in
    the (nz, ny, nx, cap) grid, d the three components of x_i - x_j
    (periodic wrap applied), r2 their squared length set to 1 where mask
    is False (invalid i or j, or the self slot), so no division reaches an
    empty slot, and for each per-slot array a of per_slot the pair (a_i,
    a_j), broadcastable to the block.
    """
    cap = cfg.cap
    gshape = (cfg.nz, cfg.ny, cfg.nx, cap)
    Lx, Ly, Lz = (box.lengths[c] if box.periodic[c] else None
                  for c in range(3))

    xg = [x[:, c].reshape(gshape) for c in range(3)]
    vg = valid.reshape(gshape)
    ag = [a.reshape(gshape) for a in per_slot]
    xoffs, yoffs = _offs(cfg.nx, box.periodic[0]), _offs(cfg.ny,
                                                          box.periodic[1])

    def xyrow(a, corrx, corry):
        row = torch.cat([_roll_nbr(a, o, 2, corrx) for o in xoffs], dim=-1)
        return torch.cat([_roll_nbr(row, o, 1, corry) for o in yoffs],
                         dim=-1)

    rows = [xyrow(xg[0], Lx, None), xyrow(xg[1], None, Ly),
            xyrow(xg[2], None, None)]
    vrow = xyrow(vg, None, None)
    arows = [xyrow(a, None, None) for a in ag]
    rowlen = len(xoffs) * len(yoffs) * cap

    # self-exclusion: in the zero shift, slot j == own slot within the
    # (ox=0, oy=0) segment of the row
    zero_seg = yoffs.index(0) * len(xoffs) + xoffs.index(0)
    ii = torch.arange(cap, device=x.device)[:, None]
    jj = torch.arange(rowlen, device=x.device)[None, :]
    not_self = jj != ii + zero_seg * cap
    one = torch.ones((), dtype=x.dtype, device=x.device)
    chunks = _cell_chunks(cfg, max_pairs)

    for dz in _offs(cfg.nz, box.periodic[2]):
        xj = [_roll_nbr(rows[0], dz, 0, None), _roll_nbr(rows[1], dz, 0, None),
              _roll_nbr(rows[2], dz, 0, Lz)]
        vj = _roll_nbr(vrow, dz, 0, None)
        aj = [_roll_nbr(row, dz, 0, None) for row in arows]
        for sl in chunks:
            d = [xg[c][sl][..., :, None] - xj[c][sl][..., None, :]
                 for c in range(3)]
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            mask = vg[sl][..., :, None] & vj[sl][..., None, :]
            if dz == 0:
                mask = mask & not_self
            pairs = [(a[sl][..., :, None], row[sl][..., None, :])
                     for a, row in zip(ag, aj)]
            yield sl, d, torch.where(mask, r2, one), mask, pairs


def cellgrid_pair_sums(x, type_, valid, box: Box, cfg: CellGridConfig,
                       pair_fn, eflag: bool, vflag: bool, bond=None, q=None,
                       special=None, cutsq=None, max_pairs=None):
    """Forces, energy and virial of a pairwise style on the cell grid.

    Plain torch sweep (tpumd/ops/cellgrid.py::cellgrid_pair_sums) over
    ``stencil_blocks``.  ``pair_fn(r2, itype, jtype)`` returns (fpair,
    evdwl); masked pairs
    arrive with r2 = 1 so no division reaches an empty slot.  type_ holds
    the per-slot values handed to pair_fn as itype and jtype (atom types,
    or any per-slot value a style needs), or None for single-type styles.
    Returns (f, evdwl or None, virial (6,) or None); energy and virial
    take 1/2 per ordered pair.

    bond: optional (bond_tags (Np,B), bond_btypes (Np,B), bond_fn, tag
    (Np,)).  2-body bonds ride the same sweep: each candidate's tag is
    matched against the i slot's partner tags, and a hit takes
    ``bond_fn(r2, btype)`` = (fbond, ebond) with no cutoff test.  A bonded
    pair takes only the bond force: the caller holds the special list to
    exactly the bond partners at weight 0.  An axis of fewer than 3
    cells presents a partner at several periodic images; the bond counts
    at the minimum image only (the configs guard L >= 2*cutneigh, and
    cutneigh covers the bond's reach, so that image is unique).  A fourth
    return value carries the 1/2-tallied bond energy (None unless eflag).

    q: per-slot charges, for charged styles with in-sweep special
    weights.  Then ``pair_fn(r2, itype, jtype, w_lj, w_coul, qi, qj)``
    returns pre-weighted (fpair, evdwl, ecoul, fcoul) (tpumd's
    ``pair_fn_ex``), and special = (tag (Np,), special_tags (Np, S), w_lj
    (Np, S), w_coul (Np, S)) or None: each candidate's tag is matched
    against the i slot's special list, w = 1 + sum_s hit_s (w_s - 1)
    (entries whose two weights are 1 were dropped at set-up).  Only the
    pairs within cutsq (the style's largest cutoff squared) are evaluated,
    gathered out of blocks of at most max_pairs candidates, which keeps
    the sweep's memory bounded; a fourth return value carries the
    1/2-tallied Coulomb energy (None unless eflag).
    """
    if q is not None:
        return _charged_pair_sums(x, type_, q, valid, box, cfg, pair_fn,
                                  special, cutsq, max_pairs, eflag, vflag)
    gshape = (cfg.nz, cfg.ny, cfg.nx, cfg.cap)
    dtype = x.dtype
    Lx, Ly, Lz = box.lengths[0], box.lengths[1], box.lengths[2]
    per_slot = [] if type_ is None else [type_]
    if bond is not None:
        btags, btypes, bond_fn, atag = bond
        per_slot.append(atag)
        nb = btags.shape[1]
        btags_g = btags.reshape(gshape + (nb,))
        btypes_g = btypes.reshape(gshape + (nb,))
        min_image_guard = min(cfg.nx, cfg.ny, cfg.nz) < 3
        ebond = torch.zeros((), dtype=dtype, device=x.device)

    fx = [torch.zeros(gshape, dtype=dtype, device=x.device)
          for _ in range(3)]
    evdwl = torch.zeros((), dtype=dtype, device=x.device)
    virial = torch.zeros(6, dtype=dtype, device=x.device)
    for sl, d, r2, mask, pairs in stencil_blocks(x, valid, box, cfg,
                                                 per_slot):
        ti, tj = pairs[0] if type_ is not None else (None, None)
        fp, e = pair_fn(r2, ti, tj)
        if bond is not None:
            tagj = pairs[-1][1]
            mask_b = mask
            if min_image_guard:
                mask_b = (mask & (torch.abs(d[0]) <= 0.5 * Lx)
                          & (torch.abs(d[1]) <= 0.5 * Ly)
                          & (torch.abs(d[2]) <= 0.5 * Lz))
            bhit = None
            btype_hit = torch.zeros(mask.shape, dtype=btypes.dtype,
                                    device=x.device)
            for bi in range(nb):
                bt = btags_g[sl][..., :, bi:bi + 1]
                hit = (bt > 0) & (bt == tagj)
                bhit = hit if bhit is None else (bhit | hit)
                btype_hit = torch.where(hit, btypes_g[sl][..., :, bi:bi + 1],
                                        btype_hit)
            bf, be = bond_fn(r2, btype_hit)
            bondmask = bhit & mask_b
            fp = torch.where(bondmask, bf, fp)
            if eflag:
                e = torch.where(bondmask, 0.0, e)
                ebond = ebond + 0.5 * torch.sum(torch.where(bondmask, be, 0))
        fp = torch.where(mask, fp, 0)
        for c in range(3):
            fx[c][sl] += torch.sum(d[c] * fp, dim=-1)
        if eflag:
            evdwl = evdwl + 0.5 * torch.sum(torch.where(mask, e, 0))
        if vflag:
            virial = virial + 0.5 * torch.stack([
                torch.sum(fp * d[0] * d[0]), torch.sum(fp * d[1] * d[1]),
                torch.sum(fp * d[2] * d[2]), torch.sum(fp * d[0] * d[1]),
                torch.sum(fp * d[0] * d[2]), torch.sum(fp * d[1] * d[2])])

    f = torch.stack([c.reshape(-1) for c in fx], dim=1)
    out = (f, (evdwl if eflag else None), (virial if vflag else None))
    if bond is not None:
        return out + ((ebond if eflag else None),)
    return out


def _charged_pair_sums(x, type_, q, valid, box: Box, cfg: CellGridConfig,
                       pair_fn, special, cutsq, max_pairs, eflag, vflag):
    """cellgrid_pair_sums for charged styles: (f, evdwl, virial, ecoul).

    Each block's in-range pairs are gathered by flat index and evaluated
    once; i-side arrays are indexed per i slot of the chunk and j-side
    arrays per entry of the chunk's rolled j-rows."""
    cap = cfg.cap
    gshape = (cfg.nz, cfg.ny, cfg.nx, cap)
    dtype = x.dtype
    per_slot = [type_, q]
    if special is not None:
        tag, stags, wl, wc = special
        per_slot.append(tag)
        S = stags.shape[1]
        sp_g = [a.reshape(gshape + (S,)) for a in (stags, wl, wc)]
    f = torch.zeros(gshape + (3,), dtype=dtype, device=x.device)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    evdwl, ecoul, virial = zero, zero, torch.zeros(6, dtype=dtype,
                                                   device=x.device)
    for sl, d, r2, mask, pairs in stencil_blocks(x, valid, box, cfg,
                                                 per_slot, max_pairs):
        rowlen = r2.shape[-1]
        keep = mask if cutsq is None else mask & (r2 < cutsq)
        flat = torch.nonzero(keep.reshape(-1)).reshape(-1)
        ii = flat // rowlen                      # i slot of the chunk
        jj = (flat // (cap * rowlen)) * rowlen + flat % rowlen  # j entry
        dd = [c.reshape(-1)[flat] for c in d]
        rr = r2.reshape(-1)[flat]

        def side_i(a):
            return a.reshape(-1)[ii]

        def side_j(a):
            return a.reshape(-1)[jj]
        ti, tj = side_i(pairs[0][0]), side_j(pairs[0][1])
        qi, qj = side_i(pairs[1][0]), side_j(pairs[1][1])
        w_lj = w_coul = torch.ones_like(rr)
        if special is not None:
            tagj = side_j(pairs[2][1])
            st, sw_l, sw_c = (a[sl].reshape(-1, S)[ii] for a in sp_g)
            hit = (st > 0) & (st == tagj[:, None])
            w_lj = 1.0 + torch.sum(torch.where(hit, sw_l - 1.0, 0.0), dim=1)
            w_coul = 1.0 + torch.sum(torch.where(hit, sw_c - 1.0, 0.0),
                                     dim=1)
        fp, e, ec, fcoul = pair_fn(rr, ti, tj, w_lj, w_coul, qi, qj)
        fp = fp + fcoul
        fi = torch.zeros(f[sl].reshape(-1, 3).shape, dtype=dtype,
                         device=x.device)
        fi.index_add_(0, ii, torch.stack([c * fp for c in dd], dim=1))
        f[sl] += fi.reshape(f[sl].shape)
        if eflag:
            evdwl = evdwl + 0.5 * torch.sum(e)
            ecoul = ecoul + 0.5 * torch.sum(ec)
        if vflag:
            virial = virial + 0.5 * torch.stack([
                torch.sum(fp * dd[0] * dd[0]), torch.sum(fp * dd[1] * dd[1]),
                torch.sum(fp * dd[2] * dd[2]), torch.sum(fp * dd[0] * dd[1]),
                torch.sum(fp * dd[0] * dd[2]), torch.sum(fp * dd[1] * dd[2])])
    return (f.reshape(-1, 3), evdwl if eflag else None,
            virial if vflag else None, ecoul if eflag else None)
