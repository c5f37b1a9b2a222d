"""Granular Hookean contact with shear history (pair gran/hooke/history).

Settings per the reference (PairGranHookeHistory::settings,
src/GRANULAR/pair_gran_hooke_history.cpp), as tpumd/models/pair_gran.py
has them: kn, kt (NULL: 2/7 kn), gamman, gammat (NULL: gamman / 2),
xmu, dampflag (0 zeroes gammat) and the optional ``limit_damping``.  The
neighbor cutoff is the largest contact distance, twice the largest
radius.  Fix freeze hands its group bit to the style (the effective-mass
rule, PairGranHookeHistory::init_style), and the set-up hands it the
``neigh_modify exclude group`` bit pairs.  On the cell grid the style
sweeps the grid's pair list, built at every re-bin with
the excluded pairs dropped: forces and torques go through the kernel
``ops/gran_cellgrid.py`` (its plain version on the CPU), which also
advances the per-contact history, KH = 12 entries a sphere (``hist_over``
records a sphere with more, whose further contacts lose their history);
on the matrix neighbor
engine through ``compute_gran`` over the (N, K) neighbor matrix, whose
(N, K, 3) history rides the neighbor slots.  The style adds no energy and
no virial, as in tpumd.

gran/hertz/history (``PairGranHertzHistory``) is the same style with the
normal and tangential forces scaled by the Hertzian factor, on both
engines (B6's HERTZ variant on the grid).  gran/hooke (``PairGranHooke``)
keeps no history: its tangential force is velocity damping capped by
Coulomb friction, on the matrix engine only, as in tpumd.
"""

from __future__ import annotations

import torch

from tpumd_torch.core.state import minimum_image_c
from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.cellgrid_gran import GranCoeffs
from tpumd_torch.ops.gather import gather_rows
from tpumd_torch.ops.gran_cellgrid import gran_cellgrid


@register_pair("gran/hooke/history")
class PairGranHookeHistory(PairStyle):
    name = "gran/hooke/history"
    is_granular = True
    # the per-contact shear history rides the neighbor state
    has_history = True
    # polyhertz = sqrt(delta r_i r_j / (r_i + r_j)) scales the forces
    is_hertz = False
    # compute_gran reads the real atoms' rows: no image copies
    supports_image_ext = False

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        self.freeze_group_bit = 0   # set by fix freeze at set-up
        self.exclude_bits = ()      # ((b1, b2), ...), set at set-up
        self._max_radius = 0.5
        # (1,) int32 on the grid's device: the largest contact count of a
        # sphere that had more than KH contacts in a sweep since the first
        # (its contacts past the KH-th lost their history), else 0
        self.hist_over = None

    def settings(self, kn, kt, gamman, gammat, xmu, dampflag, *extra):
        self.kn = float(kn)
        self.kt = self.kn * 2.0 / 7.0 if kt == "NULL" else float(kt)
        self.gamman = float(gamman)
        self.gammat = (0.5 * self.gamman if gammat == "NULL"
                       else float(gammat))
        self.xmu = float(xmu)
        self.dampflag = int(dampflag)
        if self.dampflag == 0:
            self.gammat = 0.0
        if extra and list(extra) != ["limit_damping"]:
            raise NotImplementedError(
                f"pair_style {self.name} keywords {list(extra)}: only "
                "limit_damping is ported")
        self.limit_damping = bool(extra)

    def coeff(self, ilo, ihi, jlo, jhi, *rest):
        # pair_coeff * * (the style takes no per-type coefficients)
        if rest:
            raise NotImplementedError(
                f"pair_coeff arguments {list(rest)} for {self.name}")

    def init(self):
        pass

    def set_max_radius(self, r: float):
        self._max_radius = float(r)

    @property
    def max_cutoff(self) -> float:
        # the largest contact distance (PairGranHookeHistory::init_one)
        return 2.0 * self._max_radius

    def kernel_coeffs(self) -> GranCoeffs:
        return GranCoeffs(self.kn, self.kt, self.gamman, self.gammat,
                          self.xmu, self.limit_damping,
                          int(self.freeze_group_bit), tuple(self.exclude_bits),
                          self.is_hertz)

    def compute_gran_cellgrid(self, s, valid, shear_tags, shear, cfg, dt,
                              shearupdate: bool, plist):
        """(f, torque, shear_tags, shear) of one sweep on the grid over its
        pair list plist = (pairs, npairs, rows), as ``gran_cellgrid``."""
        planes = (s.v, s.omega, s.radius,
                  torch.where(s.rmass > 0, s.rmass, 1.0), s.gmask)
        if self.hist_over is None or self.hist_over.device != s.x.device:
            self.hist_over = torch.zeros(1, dtype=torch.int32,
                                         device=s.x.device)
        return gran_cellgrid(s.x, s.tag, valid, shear_tags, shear, s.box,
                             cfg, self.kernel_coeffs(),
                             planes, dt, shearupdate, plist, self.hist_over)

    def compute_gran(self, s, idx, shear, dt, shearupdate: bool):
        """(f, torque, shear_new) on the matrix neighbor engine
        (PairGranHookeHistory::compute, src/GRANULAR/
        pair_gran_hooke_history.cpp:169-380; tpumd/models/pair_gran.py:
        69-199): each atom sums its own force and torque over its row,
        the history (N, K, 3) advancing slot by slot with shearupdate
        (shear_new is the input history without it).  The frozen group
        counts as infinite mass; excluded pairs are not in idx.  With
        is_hertz polyhertz scales the normal force before limit_damping
        clamps it, and the tangential force (pair_gran_hertz_history.cpp:
        186-189; tpumd/models/pair_gran.py:127-131, :161-162)."""
        c = _contact_terms(self, s, idx)
        d, r, rsqinv, touching, radi, meff, ccel, vtr = (
            c["d"], c["r"], c["rsqinv"], c["touching"], c["radi"],
            c["meff"], c["ccel"], c["vtr"])
        poly = c["poly"]

        # shear history: advance, then rotate out the normal part
        sh = [torch.where(touching, shear[..., c], 0.0) for c in range(3)]
        if shearupdate:
            sh = [torch.where(touching, sh[c] + vtr[c] * dt, sh[c])
                  for c in range(3)]
        shrmag = torch.sqrt(sh[0] * sh[0] + sh[1] * sh[1] + sh[2] * sh[2])
        if shearupdate:
            rsht = (sh[0] * d[0] + sh[1] * d[1] + sh[2] * d[2]) * rsqinv
            sh = [sh[c] - d[c] * rsht for c in range(3)]

        # tangential force: shear spring and tangential damping
        gt = meff * self.gammat
        fs_v = [-(self.kt * sh[c] + gt * vtr[c]) for c in range(3)]
        if poly is not None:
            fs_v = [poly * fc for fc in fs_v]
        fs = torch.sqrt(fs_v[0] ** 2 + fs_v[1] ** 2 + fs_v[2] ** 2)
        fn = self.xmu * torch.abs(ccel * r)

        # Coulomb limit: a slipping contact rescales its shear and force
        slip = touching & (fs > fn)
        ratio = fn / torch.where(fs > 0, fs, 1.0)
        nonzero = shrmag != 0.0
        resc = slip & nonzero
        for c in range(3):
            damp_t = (gt * vtr[c] / self.kt if self.kt
                      else 0.0 * vtr[c])
            sh[c] = torch.where(resc, ratio * (sh[c] + damp_t) - damp_t,
                                sh[c])
            fs_v[c] = torch.where(slip, torch.where(nonzero,
                                                    fs_v[c] * ratio, 0.0),
                                  fs_v[c])

        f, torque = _sum_contacts(d, r, touching, radi, ccel, fs_v)
        if not shearupdate:
            return f, torque, shear
        shear_new = torch.stack(
            [torch.where(touching, sh[c], 0.0) for c in range(3)], dim=-1)
        return f, torque, shear_new


def _contact_terms(style, s, idx):
    """The contact terms both matrix-engine styles share (tpumd/models/
    pair_gran.py:77-150): each row's (N, K) separation d (3-list) from its
    neighbours' packed (N, 12) rows, r, 1/r^2, the touching mask, r_i, the
    effective mass (a frozen atom counting as infinitely heavy), the
    normal force over r (ccel: Hookean contact and normal velocity
    damping, times polyhertz for a Hertzian style, then clamped at 0 with
    limit_damping), the tangential relative velocity at the contact vtr
    (3-list) and polyhertz (None for a Hookean style)."""
    x, v, omega = s.x, s.v, s.omega
    radius, rmass, gmask = s.radius, s.rmass, s.gmask
    n = idx.shape[0]
    mask = idx != torch.arange(n, dtype=idx.dtype, device=x.device)[:, None]
    # one packed (N, 12) j-side row
    cols = [x, v, omega, radius[:, None], rmass[:, None]]
    cols.append((torch.zeros_like(radius) if gmask is None
                 else gmask.to(x.dtype))[:, None])
    pj = gather_rows(torch.cat(cols, dim=1), idx)        # (N, K, 12)
    radj, mj = pj[..., 9], pj[..., 10]
    gj = pj[..., 11].to(torch.int32)

    d = [minimum_image_c(x[:, c:c + 1] - pj[..., c], s.box, c)
         for c in range(3)]
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    radi = radius[:, None]
    radsum = radi + radj
    touching = mask & (rsq < radsum * radsum)
    rsq_safe = torch.where(touching, rsq, 1.0)
    r = torch.sqrt(rsq_safe)
    rinv = 1.0 / r
    rsqinv = 1.0 / rsq_safe

    # relative velocity, its normal and tangential parts, and the
    # rotational part
    vr = [v[:, c:c + 1] - pj[..., 3 + c] for c in range(3)]
    vnnr = vr[0] * d[0] + vr[1] * d[1] + vr[2] * d[2]
    vt = [vr[c] - d[c] * (vnnr * rsqinv) for c in range(3)]
    wr = [(radi * omega[:, c:c + 1] + radj * pj[..., 6 + c]) * rinv
          for c in range(3)]

    # effective mass; a frozen atom counts as infinite mass
    mi = rmass[:, None]
    meff = mi * mj / (mi + mj)
    if style.freeze_group_bit:
        fi = (gmask[:, None] & style.freeze_group_bit) > 0
        fj = (gj & style.freeze_group_bit) > 0
        meff = torch.where(fi, mj, meff)
        meff = torch.where(fj, mi, meff)

    # normal force: the contact and normal velocity damping
    damp = meff * style.gamman * vnnr * rsqinv
    ccel = style.kn * (radsum - r) * rinv - damp
    poly = None
    if style.is_hertz:
        poly = torch.sqrt(torch.where(touching,
                                      (radsum - r) * radi * radj / radsum,
                                      0.0))
        ccel = ccel * poly
    if style.limit_damping:
        ccel = torch.clamp(ccel, min=0.0)

    # tangential relative velocity at the contact: vt + d x wr
    vtr = [vt[0] + (d[1] * wr[2] - d[2] * wr[1]),
           vt[1] + (d[2] * wr[0] - d[0] * wr[2]),
           vt[2] + (d[0] * wr[1] - d[1] * wr[0])]
    return {"d": d, "r": r, "rsqinv": rsqinv, "touching": touching,
            "radi": radi, "meff": meff, "ccel": ccel, "vtr": vtr,
            "poly": poly}


def _sum_contacts(d, r, touching, radi, ccel, fs_v):
    """(f, torque) of each row's touching contacts: f_i += d ccel + fs,
    torque_i -= r_i (d x fs) / r."""
    rinv = 1.0 / r
    f = torch.stack([torch.sum(torch.where(touching, d[c] * ccel + fs_v[c],
                                           0.0), dim=1)
                     for c in range(3)], dim=1)
    tor = [(d[1] * fs_v[2] - d[2] * fs_v[1]) * rinv,
           (d[2] * fs_v[0] - d[0] * fs_v[2]) * rinv,
           (d[0] * fs_v[1] - d[1] * fs_v[0]) * rinv]
    torque = torch.stack(
        [-torch.sum(torch.where(touching, radi * tor[c], 0.0), dim=1)
         for c in range(3)], dim=1)
    return f, torque


@register_pair("gran/hertz/history")
class PairGranHertzHistory(PairGranHookeHistory):
    """Hertzian contact with shear history (pair gran/hertz/history,
    src/GRANULAR/pair_gran_hertz_history.cpp:169-230; tpumd/models/
    pair_gran.py:230-243): gran/hooke/history with the normal force and
    the tangential force scaled by polyhertz = sqrt((r_i + r_j - r) r_i r_j
    / (r_i + r_j)).  The reference divides kn and kt by nktv2p; tpumd's
    pair does not, and neither does the port (nktv2p is 1 in lj units)."""

    name = "gran/hertz/history"
    is_hertz = True


@register_pair("gran/hooke")
class PairGranHooke(PairGranHookeHistory):
    """History-free Hookean contact (pair gran/hooke, src/GRANULAR/
    pair_gran_hooke.cpp:85-160; tpumd/models/pair_gran.py:245-325): the
    tangential force is velocity damping capped by Coulomb friction,
    ft = min(xmu |ccel r|, meff gammat |vtr|) / |vtr|.  On the matrix
    engine only, as in tpumd, whose grid path raises."""

    name = "gran/hooke"
    has_history = False
    supports_cellgrid = False

    def compute_gran(self, s, idx, shear, dt, shearupdate: bool):
        """(f, torque, shear) on the matrix neighbor engine; shear, None
        without a history, comes back as it is."""
        c = _contact_terms(self, s, idx)
        vtr, r, ccel = c["vtr"], c["r"], c["ccel"]
        vrel = torch.sqrt(vtr[0] ** 2 + vtr[1] ** 2 + vtr[2] ** 2)
        fn = self.xmu * torch.abs(ccel * r)
        fs = c["meff"] * self.gammat * vrel
        ft = torch.where(vrel != 0.0, torch.minimum(fn, fs)
                         / torch.where(vrel != 0.0, vrel, 1.0), 0.0)
        fs_v = [-ft * vtr[k] for k in range(3)]
        f, torque = _sum_contacts(c["d"], r, c["touching"], c["radi"], ccel,
                                  fs_v)
        return f, torque, shear

    def compute_gran_cellgrid(self, *args, **kw):
        raise NotImplementedError(
            "pair gran/hooke runs on the matrix neighbor engine")
