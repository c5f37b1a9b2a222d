"""pair_style adp: the angular-dependent potential, EAM with dipole and
quadrupole densities (src/MANYBODY/pair_adp.cpp), the port's copy of
tpumd/models/pair_adp.py, on the matrix engine.

  E = sum_i F_i(rho_i) + 1/2 sum_ij phi(r_ij)
      + sum_i [1/2 |mu_i|^2 + 1/2 sum_a lam_aa^2 + sum_{a<b} lam_ab^2
               - 1/6 (tr lam)^2]
with mu_i = sum_j u(r_ij) d_ij and lam_i = sum_j w(r_ij) d_ij (x) d_ij.
The forces are the reference's explicit pairwise expressions
(pair_adp.cpp:283-390) over the full neighbor rows; every spline row, the
neighbours' rows and their mu, lam and fp are row gathers (P1).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.pair_eam import PairEAMAlloy, _interpolate
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows


@register_pair("adp")
class PairADP(PairEAMAlloy):
    name = "adp"
    supports_cellgrid = False
    _reader = {"adp": True}

    def init(self):
        super().init()
        f = self._setfl
        ne = len(f.elements)
        self.u2r_spline = np.stack(
            [_interpolate(f.nr, f.dr, f.u2r[i, j])
             for i in range(ne) for j in range(ne)])
        self.w2r_spline = np.stack(
            [_interpolate(f.nr, f.dr, f.w2r[i, j])
             for i in range(ne) for j in range(ne)])

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag: bool, vflag: bool, q=None, ext=None):
        if ext is not None:
            raise NotImplementedError(
                "pair_style adp: a box narrower than 2*cutneigh (the "
                "multi-image mode) is not ported")
        d, r, inside, m, p, it, jt = self._pass_geometry(
            x, type_, box, idx, self.cutforcesq)
        t2rhor = self._index_table("type2rhor", x)
        t2pair = self._index_table("type2z2r", x)
        nr = self.nr
        ins = inside.to(x.dtype)
        # the density pass: rho, the dipole mu and the quadrupole lam
        c_ji = self._rows("rhor", t2rhor[jt, it], m, x, nr)
        rho = torch.sum(torch.where(inside, self._val(c_ji, p), 0.0), dim=1)
        pair = t2pair[it, jt]
        cu = self._rows("u2r", pair, m, x, nr)
        u2 = self._val(cu, p) * ins
        mu = torch.sum(u2[..., None] * d, dim=1)
        cw = self._rows("w2r", pair, m, x, nr)
        w2 = self._val(cw, p) * ins
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        # Voigt xx yy zz yz xz xy (the reference's lambda[0..5])
        lam = torch.stack([torch.sum(w2 * a * b, dim=1) for a, b in (
            (dx, dx), (dy, dy), (dz, dz), (dy, dz), (dx, dz), (dx, dy))],
            dim=1)
        fp, phi_e = self._embedding(type_, rho, eflag)
        e_embed = None
        if eflag:
            phi_e = phi_e + 0.5 * torch.sum(mu * mu, dim=1)
            phi_e = phi_e + 0.5 * torch.sum(lam[:, :3] * lam[:, :3], dim=1)
            phi_e = phi_e + torch.sum(lam[:, 3:] * lam[:, 3:], dim=1)
            tr = lam[:, 0] + lam[:, 1] + lam[:, 2]
            phi_e = phi_e - (1.0 / 6.0) * tr * tr
            e_embed = torch.sum(torch.where(type_ > 0, phi_e, 0.0))

        # the force pass (pair_adp.cpp:283-390)
        c_ij = self._rows("rhor", t2rhor[it, jt], m, x, nr)
        cz = self._rows("z2r", pair, m, x, nr)
        rhoip, rhojp = self._der(c_ij, p), self._der(c_ji, p)
        z2p, z2 = self._der(cz, p), self._val(cz, p)
        u2p, w2p = self._der(cu, p), self._der(cw, p)
        recip = 1.0 / r
        phi = z2 * recip
        phip = z2p * recip - phi * recip
        # the neighbours' fp, mu and lam: one packed gather
        pj = gather_rows(torch.cat([fp[:, None], mu, lam], dim=1), idx)
        psip = fp[:, None] * rhojp + pj[..., 0] * rhoip + phip
        fpair = torch.where(inside, -psip * recip, 0.0)
        delmu = mu[:, None, :] - pj[..., 1:4]
        trdelmu = torch.sum(delmu * d, dim=-1)
        sumlam = lam[:, None, :] + pj[..., 4:10]
        tradellam = (sumlam[..., 0] * dx * dx + sumlam[..., 1] * dy * dy
                     + sumlam[..., 2] * dz * dz
                     + 2.0 * sumlam[..., 5] * dx * dy
                     + 2.0 * sumlam[..., 4] * dx * dz
                     + 2.0 * sumlam[..., 3] * dy * dz)
        nu = sumlam[..., 0] + sumlam[..., 1] + sumlam[..., 2]
        lamdot = torch.stack([
            sumlam[..., 0] * dx + sumlam[..., 5] * dy + sumlam[..., 4] * dz,
            sumlam[..., 5] * dx + sumlam[..., 1] * dy + sumlam[..., 3] * dz,
            sumlam[..., 4] * dx + sumlam[..., 3] * dy + sumlam[..., 2] * dz,
        ], dim=-1)
        adp = -(delmu * u2[..., None]
                + (trdelmu * u2p * recip)[..., None] * d
                + 2.0 * w2[..., None] * lamdot
                + (w2p * recip * tradellam)[..., None] * d
                - (1.0 / 3.0) * (nu * (w2p * r + 2.0 * w2))[..., None] * d)
        adp = torch.where(inside[..., None], adp, 0.0)
        fpw = d * fpair[..., None] + adp
        f = torch.sum(fpw, dim=1)
        evdwl = None
        if eflag:
            evdwl = e_embed + 0.5 * torch.sum(torch.where(inside, phi, 0.0))
        return f, evdwl, None, (self._virial(fpw, d) if vflag else None)
