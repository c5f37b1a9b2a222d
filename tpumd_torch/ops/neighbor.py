"""Binned Verlet neighbor lists as fixed-width padded matrices.

PyTorch counterpart of tpumd/ops/neighbor.py (the reference's neighbor
subsystem, src/neighbor.cpp, src/nbin_standard.cpp,
src/npair_half_bin_newton.cpp): a dense **full** neighbor matrix
``idx[N, K]`` whose padding is each row's own index, built by

1. binning the atoms into cells of edge >= cutneigh,
2. gathering each atom's stencil candidates (the cells, then the
   candidates' coordinates),
3. keeping those within cutneigh and compacting each row into K slots by
   the running count of survivors.

Atoms keep their rows on this engine: nothing is permuted.  Special-bond
codes (0 none, 1/2/3 for 1-2/1-3/1-4) ride a parallel ``sbits[N, K]``
matrix.  Rebuilds follow Neighbor::decide (src/neighbor.cpp:2293-2360): the
every/delay schedule and the half-skin displacement check.

Every row gather goes through ``ops/gather.py::gather_rows`` (the P1
kernel on the card).  tpumd also has a roll-based build
(``_build_rolled``, tpumd/ops/neighbor.py:206-343) that avoids gathers
because a TPU pays per gathered row; its neighbor sets equal this gather
build's (only the order within a row differs), so it is not ported.

Boxes narrower than 2 cutneigh (periodic axes) take the multi-image mode:
the j-side candidates are explicit periodic copies of every atom at the
``image_shifts`` (the counterpart of the reference's multi-hop ghosts,
src/comm_brick.cpp maxneed).  Triclinic boxes bin in lamda space.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpumd_torch.core.state import Box, minimum_image
from tpumd_torch.ops.gather import gather_rows


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static neighbor-list configuration."""

    cutneigh: float           # largest force cutoff + skin
    skin: float
    nx: int                   # cells per axis (cell edge >= cutneigh)
    ny: int
    nz: int
    cell_cap: int             # atoms per cell
    kmax: int                 # neighbor slots per atom
    block: int                # atoms per build block (bounds memory)
    every: int = 1
    delay: int = 0
    check: bool = True
    has_special: bool = False     # special-bond codes to set
    # neigh_modify exclude group g1 g2: pairs of gmask bits; a pair with
    # one atom in each group is left out
    exclude_bits: tuple = ()
    # multi-image mode: periodic copies of every atom at these lattice
    # shifts are the j-side candidates; (0, 0, 0) first, so the real atoms
    # are rows [0, N).  Empty: plain minimum image.
    image_shifts: tuple = ()

    @property
    def ncells(self) -> int:
        return self.nx * self.ny * self.nz


@dataclasses.dataclass(frozen=True)
class NeighborState:
    idx: torch.Tensor        # (N, K) int32 neighbor rows; padding = own row
    sbits: torch.Tensor      # (N, K) int32 special code (0 if none)
    xhold: torch.Tensor      # (N, 3) positions at the last build
    ago: int                 # steps since the last build (host schedule)
    nbuilds: int
    overflow: torch.Tensor   # () bool: K or cell_cap exceeded at a build
    max_count: torch.Tensor  # () most neighbors of one atom at the build
    # granular shear history, slot-aligned with idx, carried across a
    # rebuild by matching j (FixNeighHistory, src/fix_neigh_history.cpp)
    shear: torch.Tensor | None = None    # (N, K, 3)

    def replace(self, **kw) -> "NeighborState":
        return dataclasses.replace(self, **kw)


def image_counts(box: Box, cutneigh: float) -> list[int]:
    """Periodic images per side that a box narrower than 2 cutneigh needs
    on each axis: floor(cutneigh / L) + 1 covers every pair in range, 0
    where the minimum image holds."""
    ell = box.widths_np()
    return [int(np.floor(cutneigh / ell[c])) + 1
            if box.periodic[c] and ell[c] < 2.0 * cutneigh else 0
            for c in range(3)]


def choose_config(box: Box, cutneigh: float, skin: float, natoms: int, *,
                  every: int = 1, delay: int = 0, check: bool = True,
                  kmax: int | None = None, cell_cap: int | None = None,
                  has_special: bool = False,
                  box_margin: float = 1.0) -> NeighborConfig:
    """Cell counts and capacities from the box and the density
    (tpumd/ops/neighbor.py:90-153).  box_margin > 1 leaves room for a
    barostat's shrinkage (cells stay >= cutneigh wide)."""
    ell = box.widths_np()
    kimg = image_counts(box, cutneigh)
    image_shifts: tuple = ()
    if any(kimg):
        if box.istriclinic:
            raise ValueError(
                f"triclinic perpendicular widths {ell} must be >= "
                f"2*cutneigh ({2 * cutneigh:.3f})")
        shifts = [(0, 0, 0)]
        for sz in range(-kimg[2], kimg[2] + 1):
            for sy in range(-kimg[1], kimg[1] + 1):
                for sx in range(-kimg[0], kimg[0] + 1):
                    if (sx, sy, sz) != (0, 0, 0):
                        shifts.append((sx, sy, sz))
        image_shifts = tuple(shifts)
        # bin over the image-extended domain
        ell = ell * (2 * np.asarray(kimg) + 1)
    nx, ny, nz = [max(1, int(np.floor(L / (cutneigh * box_margin))))
                  for L in ell]
    ncells = nx * ny * nz
    ncopies = natoms * max(1, len(image_shifts))
    density = ncopies / float(np.prod(ell))
    if cell_cap is None:
        cell_cap = int(np.ceil((ncopies / ncells * 1.8 + 3) / 4) * 4)
    if kmax is None:
        mean_neigh = density * 4.0 / 3.0 * np.pi * cutneigh**3
        kmax = int(np.ceil((mean_neigh * 1.35 + 4) / 4) * 4)
    # block size: keeps the (block, 27 cell_cap) candidate tensors at a
    # few million entries
    block = 1024
    while block * 2 <= natoms and block * 27 * cell_cap <= 4 * 1024 * 1024:
        block *= 2
    return NeighborConfig(
        cutneigh=float(cutneigh), skin=float(skin), nx=nx, ny=ny, nz=nz,
        cell_cap=int(cell_cap), kmax=int(kmax), block=block, every=every,
        delay=delay, check=check, has_special=has_special,
        image_shifts=image_shifts)


def needs_new_config(box: Box, cfg: NeighborConfig) -> bool:
    """Whether the box has left the config behind (tpumd/md/simulation.py
    :1412-1430): it now needs other periodic images, or a cell edge got
    shorter than cutneigh, so the stencil could miss pairs."""
    kimg = image_counts(box, cfg.cutneigh)
    have = (np.abs(np.asarray(cfg.image_shifts)).max(axis=0).tolist()
            if cfg.image_shifts else [0, 0, 0])
    if kimg != have:
        return True
    ell = box.widths_np() * (2 * np.asarray(kimg) + 1)
    return bool((ell / np.array([cfg.nx, cfg.ny, cfg.nz])
                 < cfg.cutneigh).any())


def ext_box(box: Box, cfg: NeighborConfig) -> Box:
    """The box of the image-extended domain: an axis with images becomes
    non-periodic (the copies stand for its periodicity); the others keep
    the minimum image."""
    kmax_d = np.abs(np.asarray(cfg.image_shifts)).max(axis=0)
    ell = box.lengths
    k = torch.as_tensor(kmax_d, dtype=ell.dtype, device=ell.device)
    return box.replace(lo=box.lo - k * ell, hi=box.hi + k * ell,
                       periodic=tuple(bool(p) and int(kk) == 0
                                      for p, kk in zip(box.periodic,
                                                       kmax_d)))


def ext_coords(x, box: Box, cfg: NeighborConfig):
    """(S N, 3) image-copy coordinates; rows [0, N) are the real atoms."""
    ell = box.lengths
    sh = torch.as_tensor(cfg.image_shifts, dtype=x.dtype, device=x.device)
    return torch.cat([x + sv * ell for sv in sh])


def _cell_index(x, box: Box, cfg: NeighborConfig):
    """(flat cell id (N,), per-axis cell (N, 3)) of each position, clamped
    into the grid; a triclinic box bins in lamda space (sheared cells,
    the same 27-cell stencil)."""
    dims = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.int32,
                        device=x.device)
    if box.istriclinic:
        rel = box.x2lamda(x) * dims
    else:
        rel = (x - box.lo) / box.lengths * dims
    ci = torch.minimum(torch.clamp(torch.floor(rel).to(torch.int32), min=0),
                       dims - 1)
    return (ci[:, 2] * cfg.ny + ci[:, 1]) * cfg.nx + ci[:, 0], ci


def stencil_offsets(cfg: NeighborConfig) -> list[tuple[int, int, int]]:
    """Per-axis stencil offsets; an axis of fewer than 3 cells takes each
    cell once (with 2 cells, -1 and +1 are the same cell)."""
    def offs(n):
        return (-1, 0, 1) if n >= 3 else ((0, -1) if n == 2 else (0,))
    return [(dx, dy, dz) for dz in offs(cfg.nz) for dy in offs(cfg.ny)
            for dx in offs(cfg.nx)]


def _stencil_cells(ci, cfg: NeighborConfig):
    """(N, S) int32 flat ids of the periodic cell stencil of each atom."""
    offs = torch.tensor(stencil_offsets(cfg), dtype=torch.int32,
                        device=ci.device)
    dims = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.int32,
                        device=ci.device)
    nb = torch.remainder(ci[:, None, :] + offs[None, :, :], dims)
    return ((nb[:, :, 2] * cfg.ny + nb[:, :, 1]) * cfg.nx
            + nb[:, :, 0]).contiguous()


def excluded_pairs(gi, gj, exclude_bits):
    """Pairs with one atom in each group of an excluded pair of bits."""
    out = torch.zeros(torch.broadcast_shapes(gi.shape, gj.shape),
                      dtype=torch.bool, device=gi.device)
    for b1, b2 in exclude_bits:
        out |= (((gi & b1) > 0) & ((gj & b2) > 0)) | (
            ((gi & b2) > 0) & ((gj & b1) > 0))
    return out


def build_neighbors(x, box: Box, cfg: NeighborConfig, special_tags=None,
                    special_codes=None, tag=None, gmask=None, rows=None):
    """The padded neighbor matrix of wrapped positions x (N, 3)
    (tpumd/ops/neighbor.py:344-490).  Returns (idx (N, K) int32, sbits
    (N, K) int32, max_count, overflow).  special_tags/special_codes:
    (N, S) int32 partner tags (0-padded) and their codes, with tag (N,);
    gmask (N,) int32 is needed when cfg.exclude_bits is set.  rows = (r0,
    r1), where given, builds the rows [r0, r1) only (a rank's block, the
    positions every row's): idx (r1 - r0, K) of indices into x, each
    row's padding its own index r0 + row; its special codes match the
    block's special_tags (r1 - r0, S) against tag, every row's tags; a
    block takes no exclusions."""
    n = x.shape[0]
    r0, r1 = (0, n) if rows is None else rows
    if rows is not None and cfg.exclude_bits:
        raise NotImplementedError("neigh_modify exclude on a block of rows")
    dev = x.device
    i32 = torch.int32
    if cfg.image_shifts:
        nshift = len(cfg.image_shifts)
        bbox = ext_box(box, cfg)
        xj_all = ext_coords(x, box, cfg)
        nj = nshift * n
        cell_id, _ = _cell_index(xj_all, bbox, cfg)
        _, ci = _cell_index(x, bbox, cfg)     # stencils of the real rows
        gmask_j = gmask.repeat(nshift) if cfg.exclude_bits else gmask
    else:
        bbox, xj_all, nj = box, x, n
        cell_id, ci = _cell_index(x, box, cfg)
        gmask_j = gmask

    # bin into a (ncells, cell_cap) table of rows; empty entries hold nj,
    # the row of a point far outside the cutoff
    sorted_cid, order = torch.sort(cell_id, stable=True)
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(nj, device=dev) - first
    cell_over = torch.max(rank) >= cfg.cell_cap
    cells = torch.full((cfg.ncells, cfg.cell_cap), nj, dtype=i32, device=dev)
    # an overflowing cell keeps some of its atoms; the flag says so
    cells[sorted_cid.long(), torch.clamp(rank, max=cfg.cell_cap - 1)] = \
        order.to(i32)

    stencil = _stencil_cells(ci, cfg)
    ell = bbox.lengths
    far = (bbox.hi + 2 * cfg.cutneigh)[None]
    cols = [torch.cat([xj_all, far])]
    if cfg.exclude_bits:
        cols.append(torch.cat([gmask_j, gmask_j.new_zeros(1)])
                    .to(x.dtype)[:, None])
        gmask_i = gmask[:n]
    xp = torch.cat(cols, dim=1).contiguous()
    cut2 = cfg.cutneigh * cfg.cutneigh

    idx = torch.empty((r1 - r0, cfg.kmax), dtype=i32, device=dev)
    counts = torch.empty(r1 - r0, dtype=torch.int64, device=dev)
    for b0 in range(r0, r1, cfg.block):
        b1 = min(b0 + cfg.block, r1)
        cand = gather_rows(cells, stencil[b0:b1]).reshape(b1 - b0, -1)
        pj = gather_rows(xp, cand)                      # (B, C, 3 or 4)
        xi = x[b0:b1]
        if box.istriclinic:
            d3 = minimum_image(xi[:, None, :] - pj[..., :3], box)
            r2 = d3[..., 0] * d3[..., 0] + d3[..., 1] * d3[..., 1] \
                + d3[..., 2] * d3[..., 2]
        else:
            r2 = torch.zeros(cand.shape, dtype=x.dtype, device=dev)
            for c in range(3):
                dc = xi[:, c:c + 1] - pj[:, :, c]
                if bbox.periodic[c]:
                    dc = dc - ell[c] * torch.round(dc / ell[c])
                r2 = r2 + dc * dc
        self_b = torch.arange(b0, b1, dtype=i32, device=dev)[:, None]
        ok = (r2 < cut2) & (cand != self_b) & (cand < nj)
        if cfg.exclude_bits:
            ok &= ~excluded_pairs(gmask_i[b0:b1, None], pj[:, :, 3].to(i32),
                             cfg.exclude_bits)
        # survivors in candidate order: the k-th goes to slot k; those
        # past kmax land in the dropped column kmax (overflow is flagged)
        pos = torch.cumsum(ok, dim=1) - 1
        col = torch.where(ok, torch.clamp(pos, max=cfg.kmax), cfg.kmax)
        out = self_b.expand(b1 - b0, cfg.kmax + 1).clone()
        out.scatter_(1, col, torch.where(ok, cand, self_b))
        idx[b0 - r0:b1 - r0] = out[:, :cfg.kmax]
        counts[b0 - r0:b1 - r0] = ok.sum(dim=1)
    max_count = (torch.max(counts) if r1 > r0
                 else torch.zeros((), device=dev))
    overflow = cell_over | (max_count > cfg.kmax)

    if cfg.has_special and special_tags is not None:
        tag_j = tag.repeat(len(cfg.image_shifts)) if cfg.image_shifts \
            else tag
        jtags = gather_rows(tag_j.reshape(-1, 1), idx)[..., 0]   # (N, K)
        match = jtags[:, :, None] == special_tags[:, None, :]
        code = torch.amax(torch.where(match, special_codes[:, None, :], 0),
                          dim=-1)
        own = torch.arange(r0, r1, dtype=i32, device=dev)[:, None]
        sbits = torch.where(idx == own, 0, code).to(i32)
    else:
        sbits = torch.zeros_like(idx)
    return idx, sbits, max_count, overflow


def displacement_exceeded(x, xhold, box: Box, skin: float) -> torch.Tensor:
    """Half-skin trigger (Neighbor::check_distance,
    src/neighbor.cpp:2322-2360): some atom moved more than skin/2 since
    the last build, across a wrap by the minimum image."""
    d = minimum_image(x - xhold, box)
    rsq = torch.sum(d * d, dim=-1)
    return torch.max(rsq) > (0.5 * skin) ** 2
