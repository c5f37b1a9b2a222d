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
advances the per-contact history; on the matrix neighbor
engine through ``compute_gran`` over the (N, K) neighbor matrix, whose
(N, K, 3) history rides the neighbor slots.  The style adds no energy and
no virial, as in tpumd.

gran/hertz/history and gran/hooke are not ported: they raise.
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
    # compute_gran reads the real atoms' rows: no image copies
    supports_image_ext = False

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        self.freeze_group_bit = 0   # set by fix freeze at set-up
        self.exclude_bits = ()      # ((b1, b2), ...), set at set-up
        self._max_radius = 0.5

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
                          int(self.freeze_group_bit), tuple(self.exclude_bits))

    def compute_gran_cellgrid(self, s, valid, shear_tags, shear, cfg, dt,
                              shearupdate: bool, plist):
        """(f, torque, shear_tags, shear) of one sweep on the grid over its
        pair list plist = (pairs, npairs, rows), as ``gran_cellgrid``."""
        planes = (s.v, s.omega, s.radius,
                  torch.where(s.rmass > 0, s.rmass, 1.0), s.gmask)
        return gran_cellgrid(s.x, s.tag, valid, shear_tags, shear, s.box,
                             cfg, self.kernel_coeffs(),
                             planes, dt, shearupdate, plist)

    def compute_gran(self, s, idx, shear, dt, shearupdate: bool):
        """(f, torque, shear_new) on the matrix neighbor engine
        (PairGranHookeHistory::compute, src/GRANULAR/
        pair_gran_hooke_history.cpp:169-380; tpumd/models/pair_gran.py:
        69-199): each atom sums its own force and torque over its row,
        the history (N, K, 3) advancing slot by slot with shearupdate
        (shear_new is the input history without it).  The frozen group
        counts as infinite mass; excluded pairs are not in idx."""
        x, v, omega = s.x, s.v, s.omega
        radius, rmass, gmask = s.radius, s.rmass, s.gmask
        n = idx.shape[0]
        mask = idx != torch.arange(n, dtype=idx.dtype,
                                   device=x.device)[:, None]
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
        if self.freeze_group_bit:
            fi = (gmask[:, None] & self.freeze_group_bit) > 0
            fj = (gj & self.freeze_group_bit) > 0
            meff = torch.where(fi, mj, meff)
            meff = torch.where(fj, mi, meff)

        # normal force: Hookean contact and normal velocity damping
        damp = meff * self.gamman * vnnr * rsqinv
        ccel = self.kn * (radsum - r) * rinv - damp
        if self.limit_damping:
            ccel = torch.clamp(ccel, min=0.0)

        # tangential relative velocity at the contact: vt + d x wr
        vtr = [vt[0] + (d[1] * wr[2] - d[2] * wr[1]),
               vt[1] + (d[2] * wr[0] - d[0] * wr[2]),
               vt[2] + (d[0] * wr[1] - d[1] * wr[0])]

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

        f = torch.stack([torch.sum(torch.where(touching, d[c] * ccel
                                               + fs_v[c], 0.0), dim=1)
                         for c in range(3)], dim=1)
        # torque_i -= r_i (d x fs) / r
        tor = [(d[1] * fs_v[2] - d[2] * fs_v[1]) * rinv,
               (d[2] * fs_v[0] - d[0] * fs_v[2]) * rinv,
               (d[0] * fs_v[1] - d[1] * fs_v[0]) * rinv]
        torque = torch.stack(
            [-torch.sum(torch.where(touching, radi * tor[c], 0.0), dim=1)
             for c in range(3)], dim=1)
        if not shearupdate:
            return f, torque, shear
        shear_new = torch.stack(
            [torch.where(touching, sh[c], 0.0) for c in range(3)], dim=-1)
        return f, torque, shear_new


def _unported(name, why):
    class Unported(PairStyle):
        def __init__(self, ntypes):
            raise NotImplementedError(f"pair_style {name} is not ported: "
                                      f"{why}")
    register_pair(name)(Unported)


_unported("gran/hertz/history", "it would be a Hertzian flag of the "
          "gran/hooke/history kernel (B6), still to come")
_unported("gran/hooke", "it would be a history-free variant of the matrix "
          "engine's compute_gran (tpumd/models/pair_gran.py:240-321), "
          "still to come")
