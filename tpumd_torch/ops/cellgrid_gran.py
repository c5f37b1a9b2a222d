"""Granular contact forces on the cell grid with compact tag-keyed shear
history: the plain PyTorch versions of the B6 kernel.

PyTorch counterpart of tpumd/ops/cellgrid_gran.py::gran_compact_sums
(pair gran/hooke/history + FixNeighHistory, src/GRANULAR/
pair_gran_hooke_history.cpp:169-380, src/fix_neigh_history.cpp), and of
its ``hertz`` flag (pair gran/hertz/history: GranCoeffs.hertz).  The
history lives per atom, so a re-bin moves it with the atoms:

    shear_tags (Np, KH) int32   partner tag of each live contact (0 = none)
    shear      (Np, KH, 3)      its accumulated tangential displacement

A sweep visits the candidates of every i slot in tpumd's order: the z
offsets in turn, and within each the folded row (y offset, x offset, j
slot).  A touching pair (valid, not the slot itself, not excluded by
group bits, r < r_i + r_j) fetches its old shear by matching the
candidate's tag against the i slot's KH entries, and with ``shearupdate``
the touching contacts are re-compacted into fresh tables in that order:
the k-th contact of a slot takes entry k, and a contact of rank KH or
more still adds its force but loses its history, as in tpumd.  Without
``shearupdate`` (set-up and thermo evaluations) the history is read, not
advanced, and the tables come back as they were.

Two sweeps compute it.  ``gran_pairlist_plain``, the plain version of the
kernel, walks each slot's row of the grid's pair list
(ops/cellgrid_pairlist.py), which holds the candidates within cutneigh in
the same stencil order with the excluded pairs dropped, so its k-th
contact is the stencil's k-th and takes the same history entry.
``gran_compact_sums`` walks the stencil itself and tests the exclusions
pair by pair: the oracle the list sweep is held to; no run calls it.  Only
the touching pairs are evaluated: the stencil's contacts are gathered by
flat index out of memory-bounded chunks of i cells, the list's out of its
rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops.cellgrid import CellGridConfig, stencil_blocks
from tpumd_torch.ops.cellgrid_pairlist import image_shift, unpack
from tpumd_torch.ops.neighbor import excluded_pairs

KH = 12   # history entries per atom (the kissing number of equal spheres)


class GranCoeffs(NamedTuple):
    """What the granular sweep reads besides the atoms (tpumd's params)."""
    kn: float
    kt: float
    gamman: float
    gammat: float
    xmu: float
    limit_damping: bool
    freeze_bit: int        # gmask bit of fix freeze's group, or 0
    exclude_bits: tuple    # ((b1, b2), ...) group-bit pairs never in contact
    # gran/hertz/history: polyhertz scales the normal and tangential forces
    hertz: bool = False


def _slot_offset(sl, cfg: CellGridConfig) -> int:
    """First slot of a chunk of stencil_blocks (its cells are contiguous)."""
    z, y, x = (s.start or 0 for s in sl)
    return ((z * cfg.ny + y) * cfg.nx + x) * cfg.cap


def _old_shear(shear_tags, shear, ig, tagj):
    """(3,) lists of each contact's old shear: the i slot's entry holding
    the partner's tag, 0 when none."""
    st = shear_tags[ig]                              # (nc, KH)
    hit = ((st > 0) & (st == tagj[:, None])).to(shear.dtype)
    sh_old = shear[ig]                               # (nc, KH, 3)
    return [torch.sum(hit * sh_old[..., k], dim=1) for k in range(3)]


def _contacts(dd, rsq, vi, vj, oi, oj, radi, radj, mi, rmj, gi, gj, sh,
              c: GranCoeffs, dt: float, shearupdate: bool):
    """(force on i (nc, 3), torque on i (nc, 3), shear after the step (3,)
    list) of touching pairs, d = x_i - x_j, their old shear sh."""
    kn, kt, gamman, gammat, xmu = c.kn, c.kt, c.gamman, c.gammat, c.xmu
    radsum = radi + radj
    r = torch.sqrt(rsq)
    rinv = 1.0 / r
    rsqinv = 1.0 / rsq

    # relative velocity, its normal and tangential parts, and the
    # relative rotational velocity
    vr = [vi[k] - vj[k] for k in range(3)]
    vnnr = vr[0] * dd[0] + vr[1] * dd[1] + vr[2] * dd[2]
    vt = [vr[k] - dd[k] * (vnnr * rsqinv) for k in range(3)]
    wr = [(radi * oi[k] + radj * oj[k]) * rinv for k in range(3)]

    # effective mass; a frozen atom counts as infinitely heavy
    meff = mi * rmj / (mi + rmj)
    if c.freeze_bit:
        meff = torch.where((gi & c.freeze_bit) > 0, rmj, meff)
        meff = torch.where((gj & c.freeze_bit) > 0, mi, meff)

    damp = meff * gamman * vnnr * rsqinv
    ccel = kn * (radsum - r) * rinv - damp
    poly = None
    if c.hertz:
        # polyhertz (pair_gran_hertz_history.cpp:186-189; tpumd/ops/
        # cellgrid_gran.py:160-166): before limit_damping clamps
        poly = torch.sqrt((radsum - r) * radi * radj / radsum)
        ccel = ccel * poly
    if c.limit_damping:
        ccel = torch.clamp(ccel, min=0.0)

    vtr = [vt[0] + (dd[1] * wr[2] - dd[2] * wr[1]),
           vt[1] + (dd[2] * wr[0] - dd[0] * wr[2]),
           vt[2] + (dd[0] * wr[1] - dd[1] * wr[0])]

    if shearupdate:
        sh = [sh[k] + vtr[k] * dt for k in range(3)]
    shrmag = torch.sqrt(sh[0] * sh[0] + sh[1] * sh[1] + sh[2] * sh[2])
    if shearupdate:
        rsht = (sh[0] * dd[0] + sh[1] * dd[1] + sh[2] * dd[2]) * rsqinv
        sh = [sh[k] - dd[k] * rsht for k in range(3)]

    # tangential force: shear spring and tangential damping, rescaled
    # to the Coulomb limit when slipping
    gt = meff * gammat
    fs_v = [-(kt * sh[k] + gt * vtr[k]) for k in range(3)]
    if poly is not None:
        fs_v = [poly * fk for fk in fs_v]
    fs = torch.sqrt(fs_v[0] ** 2 + fs_v[1] ** 2 + fs_v[2] ** 2)
    fn = xmu * torch.abs(ccel * r)
    slip = fs > fn
    ratio = fn / torch.where(fs > 0, fs, 1.0)
    nonzero = shrmag != 0.0
    resc = slip & nonzero
    for k in range(3):
        damp_t = gt * vtr[k] / kt if kt else 0.0 * vtr[k]
        sh[k] = torch.where(resc, ratio * (sh[k] + damp_t) - damp_t,
                            sh[k])
        fs_v[k] = torch.where(slip, torch.where(nonzero, fs_v[k] * ratio,
                                                0.0), fs_v[k])

    force = torch.stack([dd[k] * ccel + fs_v[k] for k in range(3)], dim=1)
    tor = [(dd[1] * fs_v[2] - dd[2] * fs_v[1]) * rinv,
           (dd[2] * fs_v[0] - dd[0] * fs_v[2]) * rinv,
           (dd[0] * fs_v[1] - dd[1] * fs_v[0]) * rinv]
    torque = torch.stack([-(radi * tor[k]) for k in range(3)], dim=1)
    return force, torque, sh


def _rank_in_row(ig, count):
    """Rank of each contact in its i slot's run of consecutive contacts,
    after the count[ig] already met (contacts sorted by slot)."""
    first = torch.searchsorted(ig, ig, side="left")
    return count[ig] + torch.arange(len(ig), device=ig.device) - first


def gran_compact_sums(x, tag, valid, shear_tags, shear, box: Box,
                      cfg: CellGridConfig, c: GranCoeffs, planes, dt: float,
                      shearupdate: bool, max_pairs=None):
    """One granular force sweep with compact history over the stencil.

    planes: (v (Np, 3), omega (Np, 3), radius (Np,), rmass (Np,) with 1
    in empty slots, gmask (Np,) int32 or None when no bit is used).
    Returns (f (Np, 3), torque (Np, 3), shear_tags_new, shear_new)."""
    v, omega, rad, rm, gm = planes
    np_ = x.shape[0]
    dtype, dev = x.dtype, x.device
    if max_pairs is None:
        max_pairs = 1 << (20 if dev.type == "cpu" else 24)
    if gm is None:
        if c.freeze_bit or c.exclude_bits:
            raise ValueError("gran_compact_sums: group bits need gmask")
        gm = torch.zeros(np_, dtype=torch.int32, device=dev)
    per_slot = [v[:, 0], v[:, 1], v[:, 2], omega[:, 0], omega[:, 1],
                omega[:, 2], rad, rm, gm, tag]
    f = torch.zeros((np_, 3), dtype=dtype, device=dev)
    tq = torch.zeros((np_, 3), dtype=dtype, device=dev)
    count = torch.zeros(np_, dtype=torch.int64, device=dev)
    if shearupdate:
        new_tags = torch.zeros_like(shear_tags)
        new_shear = torch.zeros_like(shear)

    for sl, d, r2, mask, pairs in stencil_blocks(x, valid, box, cfg,
                                                 per_slot, max_pairs):
        rowlen = r2.shape[-1]
        mask = mask & ~excluded_pairs(*pairs[8], c.exclude_bits)
        radsum_b = pairs[6][0] + pairs[6][1]
        touching = mask & (r2 < radsum_b * radsum_b)
        flat = torch.nonzero(touching.reshape(-1)).reshape(-1)
        if flat.numel() == 0:
            continue
        ii = flat // rowlen                      # i slot of the chunk
        jj = (flat // (cfg.cap * rowlen)) * rowlen + flat % rowlen
        ig = _slot_offset(sl, cfg) + ii          # i slot of the grid

        def side(k, s):
            a = pairs[k][s]
            return a.reshape(-1)[jj if s else ii]
        tagj = side(9, 1)
        force, torque, sh = _contacts(
            [a.reshape(-1)[flat] for a in d], r2.reshape(-1)[flat],
            [side(k, 0) for k in range(3)], [side(k, 1) for k in range(3)],
            [side(3 + k, 0) for k in range(3)],
            [side(3 + k, 1) for k in range(3)], side(6, 0), side(6, 1),
            side(7, 0), side(7, 1), side(8, 0), side(8, 1),
            _old_shear(shear_tags, shear, ig, tagj), c, dt, shearupdate)
        f.index_add_(0, ig, force)
        tq.index_add_(0, ig, torque)

        if shearupdate:
            # rank of each contact within its i slot's row of this shift
            # (flat is sorted, so a slot's contacts are consecutive)
            pos = _rank_in_row(ig, count)
            keep = pos < KH
            kg, kp = ig[keep], pos[keep]
            new_tags[kg, kp] = tagj[keep]
            new_shear[kg, kp] = torch.stack(sh, dim=1)[keep]
        count.index_add_(0, ig, torch.ones_like(ig))

    if shearupdate:
        return f, tq, new_tags, new_shear
    return f, tq, shear_tags, shear


def gran_pairlist_plain(x, tag, shear_tags, shear, box: Box, c: GranCoeffs,
                        planes, dt: float, shearupdate: bool, pairs,
                        npairs, over=None):
    """Plain PyTorch version of the B6 kernel: one granular force sweep
    with compact history over the rows of the grid's pair list (pairs
    (Np, K), npairs (Np,), built at cutneigh with c.exclude_bits
    dropped), d = x_i - (x_j + image_shift) at the current box; arguments
    and returns as ``gran_compact_sums``.  The k-th contact along a row
    takes history entry k; with shearupdate, over (an int32 (1,) tensor, or
    None) is raised to the contact count of any row with more than KH."""
    v, omega, rad, rm, gm = planes
    np_ = x.shape[0]
    dev = x.device
    if gm is None:
        if c.freeze_bit:
            raise ValueError("gran_pairlist_plain: group bits need gmask")
        gm = torch.zeros(np_, dtype=torch.int32, device=dev)
    kk = max(int(npairs.max()), 1)
    live = (torch.arange(kk, device=dev)[None, :]
            < npairs[:, None].long())
    ii, col = torch.nonzero(live, as_tuple=True)   # row-major: row order
    jj = unpack(pairs[:, :kk])[0][ii, col].long()
    d0 = x[ii] - x[jj]
    d = x[ii] - (x[jj] + image_shift(d0, box))
    rsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    radsum = rad[ii] + rad[jj]
    touching = rsq < radsum * radsum
    ig, jg = ii[touching], jj[touching]
    tagj = tag[jg]
    force, torque, sh = _contacts(
        list(d[touching].unbind(1)), rsq[touching],
        list(v[ig].unbind(1)), list(v[jg].unbind(1)),
        list(omega[ig].unbind(1)), list(omega[jg].unbind(1)), rad[ig],
        rad[jg], rm[ig], rm[jg], gm[ig], gm[jg],
        _old_shear(shear_tags, shear, ig, tagj), c, dt, shearupdate)
    f = torch.zeros_like(x).index_add_(0, ig, force)
    tq = torch.zeros_like(x).index_add_(0, ig, torque)
    if not shearupdate:
        return f, tq, shear_tags, shear
    pos = _rank_in_row(ig, torch.zeros(np_, dtype=torch.int64, device=dev))
    if over is not None:
        most = torch.bincount(ig, minlength=np_).max().to(over.dtype)
        over.copy_(torch.maximum(over, torch.where(most > KH, most, 0)))
    keep = pos < KH
    new_tags = torch.zeros_like(shear_tags)
    new_shear = torch.zeros_like(shear)
    new_tags[ig[keep], pos[keep]] = tagj[keep]
    new_shear[ig[keep], pos[keep]] = torch.stack(sh, dim=1)[keep]
    return f, tq, new_tags, new_shear
