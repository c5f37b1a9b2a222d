"""MSM, the multilevel summation method (kspace_style msm), and the pair
styles that live beside it in tpumd: lj/cut/coul/msm and lj/long/coul/long.

PyTorch counterpart of tpumd/models/kspace_msm.py (the reference's
src/KSPACE/msm.cpp, pair_lj_cut_coul_msm.cpp and
pair_lj_long_coul_long.cpp).  The Coulomb kernel splits into a short-range
part, the pair style's gamma() taper, and a hierarchy of grid levels, each
a local direct sum with the weights gamma(rho)/(2^n a) - gamma(rho/2)/
(2^(n+1) a), joined by order-p restriction and prolongation.  tpumd's
arithmetic is kept: every level's direct sum is a periodic convolution,
evaluated as a circulant FFT product (``torch.fft``) with the weights
folded modulo the level's grid; restriction and prolongation are separable
odd-tap convolutions (rolls) with 2x down- and up-sampling.  The grid is
set_grid_global's default branch (msm.cpp:950, :167-228 in tpumd): the
cost-optimal spacing, rounded to powers of two, and the Coulomb cutoff
adjusted to meet the accuracy, which the pair style then takes.  The
virial is the scalar pressure of kspace_modify pressure/scalar yes, MSM's
default: e_long/3 on each diagonal term.  The charge stencil's derivative
weights come from autograd of the interpolation polynomials (tpumd: their
jax.grad).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.pair_misc import A1, A2, A3, A4, A5, EWALD_F, \
    EWALD_P, PairLJCutCoulCut, lj_terms
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.pairwise import pair_sums

# KSpace::KSpace gcons/dgcons tables (src/kspace.cpp:101-148)
GCONS = {
    2: [15.0 / 8.0, -5.0 / 4.0, 3.0 / 8.0],
    3: [35.0 / 16.0, -35.0 / 16.0, 21.0 / 16.0, -5.0 / 16.0],
    4: [315.0 / 128.0, -105.0 / 32.0, 189.0 / 64.0, -45.0 / 32.0,
        35.0 / 128.0],
    5: [693.0 / 256.0, -1155.0 / 256.0, 693.0 / 128.0, -495.0 / 128.0,
        385.0 / 256.0, -63.0 / 256.0],
}
DGCONS = {
    2: [-5.0 / 2.0, 3.0 / 2.0],
    3: [-35.0 / 8.0, 21.0 / 4.0, -15.0 / 8.0],
    4: [-105.0 / 16.0, 189.0 / 16.0, -135.0 / 16.0, 35.0 / 16.0],
    5: [-1155.0 / 128.0, 693.0 / 32.0, -1485.0 / 64.0, 385.0 / 32.0,
        -315.0 / 128.0],
}
# MSM's error model constants by p = order - 1 (msm.cpp:1056-1078)
_ERROR_TABLE = {3: (9, 1 / 6, 0.39189561), 5: (825, 1 / 30, 0.150829428),
                7: (130095, 1 / 140, 0.049632967),
                9: (34096545, 1 / 630, 0.013520855)}


def gamma(rho, order: int, where=np.where):
    """KSpace::gamma (src/kspace.h:147): the even polynomial taper inside
    rho <= 1, 1/rho outside; numpy arrays or (with where=torch.where)
    tensors."""
    c = GCONS[order // 2]
    rho2 = rho * rho
    g = c[0] + 0.0 * rho
    rn = rho2
    for n in range(1, order // 2 + 1):
        g = g + c[n] * rn
        rn = rn * rho2
    return where(rho <= 1.0, g, 1.0 / where(rho > 1.0, rho, 1.0))


def dgamma(rho, order: int):
    """KSpace::dgamma on tensors."""
    c = DGCONS[order // 2]
    rho2 = rho * rho
    dg = c[0] * rho
    rn = rho * rho2
    for n in range(1, order // 2):
        dg = dg + c[n] * rn
        rn = rn * rho2
    safe = torch.where(rho > 1.0, rho, 1.0)
    return torch.where(rho <= 1.0, dg, -1.0 / (safe * safe))


def compute_phi(xi, order: int, where=np.where):
    """MSM::compute_phi (msm.cpp:2909): the order-p interpolation basis, on
    numpy arrays or (with where=torch.where) tensors."""
    a = abs(xi)
    x2 = a * a
    if order == 4:
        return where(a <= 1, (1.0 - a) * (1.0 + a - 1.5 * x2),
                     where(a <= 2, -0.5 * (a - 1.0) * (2.0 - a) * (2.0 - a),
                           0.0))
    if order == 6:
        return where(
            a <= 1, (1.0 - x2) * (2.0 - a) * (6.0 + 3.0 * a - 5.0 * x2)
            / 12.0,
            where(a <= 2, -(a - 1.0) * (2.0 - a) * (3.0 - a)
                  * (4.0 + 9.0 * a - 5.0 * x2) / 24.0,
                  where(a <= 3, (a - 1.0) * (a - 2.0) * (3.0 - a)
                        * (3.0 - a) * (4.0 - a) / 24.0, 0.0)))
    if order == 8:
        return where(
            a <= 1, (1.0 - x2) * (4.0 - x2) * (3.0 - a)
            * (12.0 + 4.0 * a - 7.0 * x2) / 144.0,
            where(a <= 2, -(x2 - 1.0) * (2.0 - a) * (3.0 - a) * (4.0 - a)
                  * (10.0 + 12.0 * a - 7.0 * x2) / 240.0,
                  where(a <= 3, (a - 1.0) * (a - 2.0) * (3.0 - a)
                        * (4.0 - a) * (5.0 - a)
                        * (6.0 + 20.0 * a - 7.0 * x2) / 720.0,
                        where(a <= 4, -(a - 1.0) * (a - 2.0) * (a - 3.0)
                              * (4.0 - a) * (4.0 - a) * (5.0 - a)
                              * (6.0 - a) / 720.0, 0.0))))
    if order == 10:
        return where(
            a <= 1, (1.0 - x2) * (4.0 - x2) * (9.0 - x2) * (4.0 - a)
            * (20.0 + 5.0 * a - 9.0 * x2) / 2880.0,
            where(a <= 2, -(x2 - 1.0) * (4.0 - x2) * (3.0 - a) * (4.0 - a)
                  * (5.0 - a) * (6.0 + 5.0 * a - 3.0 * x2) / 1440.0,
                  where(a <= 3, (x2 - 1.0) * (a - 2.0) * (3.0 - a)
                        * (4.0 - a) * (5.0 - a) * (6.0 - a)
                        * (14.0 + 25.0 * a - 9.0 * x2) / 10080.0,
                        where(a <= 4, -(a - 1.0) * (a - 2.0) * (a - 3.0)
                              * (4.0 - a) * (5.0 - a) * (6.0 - a)
                              * (7.0 - a) * (8.0 + 35.0 * a - 9.0 * x2)
                              / 40320.0,
                              where(a <= 5, (a - 1.0) * (a - 2.0)
                                    * (a - 3.0) * (a - 4.0) * (5.0 - a)
                                    * (5.0 - a) * (6.0 - a) * (7.0 - a)
                                    * (8.0 - a) / 40320.0, 0.0)))))
    raise ValueError("MSM order must be 4, 6, 8 or 10")


def phi_and_dphi(xi, order: int):
    """(phi, dphi/dxi) of a tensor of offsets: the derivative by autograd
    of the piecewise polynomial (each element's own branch)."""
    with torch.enable_grad():
        t = xi.detach().requires_grad_(True)
        phi = compute_phi(t, order, torch.where)
        (dphi,) = torch.autograd.grad(phi.sum(), t)
    return phi.detach(), dphi


class MSM:
    """kspace_style msm accuracy (src/KSPACE/msm.cpp)."""

    style = "msm"
    order = 10
    # the pair style MSM couples to carries its taper's order
    pair_needs = "msm_order"

    def __init__(self, accuracy_relative):
        self.accuracy_relative = float(accuracy_relative)
        self.mesh_override = None
        self.gewald_override = None
        self._dev = {}

    def init(self, natoms, q, prd, units, cutoff, dynamic_box=False,
             types=None, pair=None):
        """The grid levels and the adjusted Coulomb cutoff (MSM::init,
        set_grid_global's default branch: tpumd/models/kspace_msm.py:
        150-200), which the pair style takes with MSM's order."""
        if dynamic_box:
            raise NotImplementedError(
                "kspace_style msm under a barostat is not ported (its grid "
                "is set at set-up, as in tpumd)")
        if self.mesh_override or self.gewald_override:
            raise NotImplementedError(
                "kspace_modify mesh or gewald under kspace_style msm is not "
                "ported (tpumd's MSM reads neither)")
        self.qqrd2e = units.qqr2e
        q = np.asarray(q, np.float64)
        self.qsum = float(q.sum())
        self.qsqsum = float((q * q).sum())
        self.q2 = self.qsqsum * self.qqrd2e
        self.natoms = natoms
        self.accuracy = self.accuracy_relative * units.qqr2e
        prd = self.prd = np.asarray(prd, np.float64)
        p = self.order - 1
        hmin = (3072.0 * (p + 1) / (p - 1)
                / (448.0 * np.pi + 56.0 * np.pi * self.order / 2
                   + 1701.0)) ** (1.0 / 6.0) \
            * (np.prod(prd) / natoms) ** (1.0 / 3.0)
        nmax, nlev = [], []
        for d in range(3):
            n = max(int(prd[d] / hmin), 2)
            # to a power of two, rounding to the nearer
            while (n & (n - 1)) != 0:
                k = np.log(n) / np.log(2.0)
                n = n + 1 if (k - np.floor(k)) > 0.5 else n - 1
            nmax.append(n)
            nlev.append(int(np.round(np.log2(n))) + 1)
        mp, cprime, scaling = _ERROR_TABLE[p]
        c_p = 4.0 * cprime * mp / 3.0 * scaling
        h = prd / np.asarray(nmax, np.float64)
        kfac = self.q2 * c_p / self.accuracy / np.sqrt(natoms)
        ssum = float(np.sum(h ** (2.0 * p - 2.0) / prd ** 2))
        self.cutoff = (kfac * kfac * ssum / 3.0) ** (1.0 / (2.0 * p))
        # periodic: the top level is left out
        self.levels = max(max(nlev) - 1, 1)
        self.ngrids = [tuple(max(int(2 ** (nlev[d] - n - 1)), 1)
                             for d in range(3)) for n in range(self.levels)]
        self.nlower = -(self.order - 1) // 2
        self.nupper = self.order // 2
        self._setup_kernels()
        if pair is not None:
            pair.cut_coul = self.cutoff
            pair.cut_coulsq = self.cutoff ** 2
            pair.msm_order = self.order
        self._dev = {}

    def _setup_kernels(self):
        """Each level's circulant direct-sum weights (get_g_direct :3106),
        folded modulo the level's grid so that a coarse level's wrap sums
        the aliased images; the direct range in cells is the finest
        level's (setup :340) at every level."""
        a = self.cutoff
        delinv0 = np.asarray(self.ngrids[0]) / self.prd
        hi_d = (2.0 * a * delinv0).astype(int)
        self.kernels = []
        for n, (nx, ny, nz) in enumerate(self.ngrids):
            delinv = np.array([nx, ny, nz]) / self.prd
            two_n = 2.0 ** n
            iz = np.arange(-hi_d[2], hi_d[2] + 1)
            iy = np.arange(-hi_d[1], hi_d[1] + 1)
            ix = np.arange(-hi_d[0], hi_d[0] + 1)
            r = np.sqrt((ix / delinv[0])[None, None, :] ** 2
                        + (iy / delinv[1])[None, :, None] ** 2
                        + (iz / delinv[2])[:, None, None] ** 2)
            rho = r / (two_n * a)
            g = (gamma(rho, self.order) / (two_n * a)
                 - gamma(rho / 2.0, self.order) / (2.0 * two_n * a))
            ker = np.zeros((nz, ny, nx))
            np.add.at(ker, (iz[:, None, None] % nz, iy[None, :, None] % ny,
                            ix[None, None, :] % nx), g)
            self.kernels.append(np.fft.fftn(ker))
        # restriction/prolongation taps at the odd offsets and 0
        # (:2250-2270)
        p = self.order - 1
        self.rp_offsets = [nu for nu in range(-p, p + 1)
                           if nu % 2 != 0 or nu == 0]
        self.rp_weights = [float(compute_phi(nu / 2.0, self.order))
                           for nu in self.rp_offsets]

    def _tables(self, dtype, device):
        key = (dtype, device)
        if key not in self._dev:
            cdt = torch.complex128 if dtype == torch.float64 \
                else torch.complex64
            self._dev[key] = [torch.as_tensor(k, device=device).to(cdt)
                              for k in self.kernels]
        return self._dev[key]

    def compute(self, x, q, box, eflag: bool, vflag: bool, type_=None):
        """(f (N, 3), elong () or None, virial (6,) or None) of the charges
        q at positions x (tpumd/models/kspace_msm.py:274-358)."""
        dt_ = x.dtype
        n = x.shape[0]
        kernels = self._tables(dt_, x.device)
        nx, ny, nz = self.ngrids[0]
        delinv = torch.as_tensor(np.array(self.ngrids[0]) / self.prd,
                                 dtype=dt_, device=x.device)
        gx = (x - box.lo) * delinv
        base = torch.floor(gx)
        d = base - gx                                   # in (-1, 0]
        pts = [phi_and_dphi(d + l, self.order)
               for l in range(self.nlower, self.nupper + 1)]
        w = torch.stack([p for p, _ in pts], dim=1)     # (N, order, 3)
        dw = torch.stack([dp for _, dp in pts], dim=1)
        m = w.shape[1]
        offs = torch.arange(self.nlower, self.nlower + m, device=x.device)
        ib = base.to(torch.int64)
        gi = [(ib[:, c, None] + offs) % nn
              for c, nn in enumerate((nx, ny, nz))]
        flat = ((gi[2][:, :, None, None] * ny + gi[1][:, None, :, None])
                * nx + gi[0][:, None, None, :]).reshape(-1)
        wz, wy, wx = (w[:, :, 2][:, :, None, None],
                      w[:, :, 1][:, None, :, None],
                      w[:, :, 0][:, None, None, :])
        qgrid = torch.zeros(nz * ny * nx, dtype=dt_, device=x.device)
        qgrid.index_add_(0, flat,
                         (q[:, None, None, None] * wz * wy * wx).reshape(-1))
        # restrict down, convolve each level (FFT), prolongate back up
        qgrids = [qgrid.reshape(nz, ny, nx)]
        for _ in range(self.levels - 1):
            qgrids.append(self._restrict(qgrids[-1]))
        egrid = None
        for lev in range(self.levels - 1, -1, -1):
            e_lev = torch.fft.ifftn(torch.fft.fftn(qgrids[lev])
                                    * kernels[lev]).real
            egrid = e_lev if egrid is None else e_lev + self._prolong(
                egrid, self.ngrids[lev])
        erow = egrid.reshape(-1)[flat].reshape(n, m, m, m)
        dwz, dwy, dwx = (dw[:, :, 2][:, :, None, None],
                         dw[:, :, 1][:, None, :, None],
                         dw[:, :, 0][:, None, None, :])
        ek = torch.stack([
            torch.sum(erow * wz * wy * dwx, dim=(1, 2, 3)) * delinv[0],
            torch.sum(erow * wz * dwy * wx, dim=(1, 2, 3)) * delinv[1],
            torch.sum(erow * dwz * wy * wx, dim=(1, 2, 3)) * delinv[2]],
            dim=1)
        f = self.qqrd2e * q[:, None] * ek
        elong = virial = None
        if eflag or vflag:
            phi_i = torch.sum(erow * wz * wy * wx, dim=(1, 2, 3))
            e_self = self.qsqsum * float(gamma(0.0, self.order)) \
                / self.cutoff
            elong = 0.5 * self.qqrd2e * (torch.sum(q * phi_i) - e_self)
        if vflag:
            # kspace_modify pressure/scalar yes, MSM's default (:560)
            virial = torch.cat([(elong / 3.0).expand(3),
                                elong.new_zeros(3)])
        return f, elong, virial

    def _restrict(self, g):
        """Separable odd-tap restriction (:2250): the tap-convolved fine
        grid, downsampled."""
        for axis in range(3):
            g = sum(torch.roll(g, -nu, dims=axis) * wgt
                    for nu, wgt in zip(self.rp_offsets, self.rp_weights))
        return g[::2, ::2, ::2]

    def _prolong(self, e_coarse, nxyz):
        """The restriction's transpose: zero-stuff, then tap-convolve."""
        nx, ny, nz = nxyz
        g = e_coarse.new_zeros((nz, ny, nx))
        g[::2, ::2, ::2] = e_coarse
        for axis in range(3):
            g = sum(torch.roll(g, nu, dims=axis) * wgt
                    for nu, wgt in zip(self.rp_offsets, self.rp_weights))
        return g


@register_pair("lj/cut/coul/msm")
class PairLJCutCoulMSM(PairLJCutCoulCut):
    """LJ and MSM's short-range Coulomb, gamma() in place of erfc
    (src/KSPACE/pair_lj_cut_coul_msm.cpp:120-200).  The Coulomb forces are
    not tallied into the virial: the pair virial is the LJ virial plus
    ecoul/3 on each diagonal term (compute :154-226, MSM's scalar
    pressure)."""

    name = "lj/cut/coul/msm"
    msm_order = 10
    peratom = False

    def _lj_fn(self, r2, it, jt):
        return lj_terms(self, r2, it, jt, 1.0)

    def _coul_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        rc2 = self.cut_coulsq
        in_c = r2 < rc2
        r = torch.sqrt(r2)
        rho = r / np.sqrt(rc2)
        egamma = 1.0 - rho * gamma(rho, self.msm_order, torch.where)
        fgamma = 1.0 + (r2 / rc2) * dgamma(rho, self.msm_order)
        prefactor = self.units.qqr2e * qi * qj / r
        forcecoul = prefactor * fgamma - (1.0 - w_coul) * prefactor
        ec = torch.where(in_c, prefactor * egamma
                         - (1.0 - w_coul) * prefactor, 0.0)
        fcoul = torch.where(in_c, forcecoul / r2, 0.0)
        z = torch.zeros_like(r2)
        return z, z, ec, fcoul

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag: bool, vflag: bool, q=None, ext=None):
        f1, evdwl, _, vir = pair_sums(x, type_, box, idx, sbits,
                                      self._lj_fn, special_lj, None, eflag,
                                      vflag, ext=ext)
        f2, _, ecoul, _ = pair_sums(x, type_, box, idx, sbits, None,
                                    special_lj, special_coul,
                                    bool(eflag or vflag), False, q=q,
                                    pair_fn_ex=self._coul_fn_ex, ext=ext)
        if vflag:
            vir = vir + torch.cat([(ecoul / 3.0).expand(3),
                                   ecoul.new_zeros(3)])
        return f1 + f2, evdwl, ecoul if eflag else None, vir


@register_pair("lj/long/coul/long")
class PairLJLongCoulLong(PairLJCutCoulCut):
    """pair_style lj/long/coul/long long long cut_lj [cut_coul]
    (src/KSPACE/pair_lj_long_coul_long.cpp, its series branch): Ewald-split
    Coulomb and Ewald-split geometric dispersion, the real-space side of
    ewald/disp and pppm/disp, which set g_ewald and g_ewald_6."""

    name = "lj/long/coul/long"
    supports_image_ext = False
    g_ewald = 0.0
    g_ewald_6 = 0.0

    def settings(self, flag_lj, flag_coul, cut_lj, cut_coul=None):
        if str(flag_lj) != "long" or str(flag_coul) != "long":
            raise NotImplementedError(
                f"pair_style lj/long/coul/long {flag_lj} {flag_coul}: only "
                "'long long' is ported (as in tpumd)")
        super().settings(cut_lj, cut_coul)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        lj1, lj2, lj3, lj4, cutsq = self.pair_coeffs(
            r2, it, jt, "lj1", "lj2", "lj3", "lj4", "cutsq")
        r2inv = 1.0 / r2
        in_c = r2 < self.cut_coulsq
        r = torch.sqrt(r2)
        grij = self.g_ewald * r
        expm2 = torch.exp(-grij * grij)
        t = 1.0 / (1.0 + EWALD_P * grij)
        erfc = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2
        prefactor = self.units.qqr2e * qi * qj / r
        forcecoul = prefactor * (erfc + EWALD_F * grij * expm2) \
            - (1.0 - w_coul) * prefactor
        ec = torch.where(in_c, prefactor * erfc - (1.0 - w_coul) * prefactor,
                         0.0)
        fcoul = torch.where(in_c, forcecoul * r2inv, 0.0)
        # the repulsion stays in real space; -C/r^6 splits by g_ewald_6
        # (compute :79-93)
        g2 = self.g_ewald_6 ** 2
        g6 = g2 ** 3
        g8 = g6 * g2
        rn = r2inv * r2inv * r2inv
        x2e = g2 * r2
        a2 = 1.0 / x2e
        x2 = a2 * torch.exp(-x2e) * lj4
        tspec = rn * (1.0 - w_lj)
        force_lj = w_lj * rn * rn * lj1 \
            - g8 * (((6.0 * a2 + 6.0) * a2 + 3.0) * a2 + 1.0) * x2 * r2 \
            + tspec * lj2
        e = w_lj * rn * rn * lj3 \
            - g6 * ((a2 + 1.0) * a2 + 0.5) * x2 + tspec * lj4
        in_lj = r2 < cutsq
        return (torch.where(in_lj, force_lj * r2inv, 0.0),
                torch.where(in_lj, e, 0.0), ec, fcoul)
