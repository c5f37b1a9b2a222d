"""pppm/disp: PPPM for Coulomb and for geometric-mixing 1/r^6 dispersion.

PyTorch counterpart of tpumd/models/kspace_pppm_disp.py (the reference's
src/KSPACE/pppm_disp.cpp), on the same mesh pipeline as ``kspace_pppm.PPPM``
(``index_add_`` assignment, ``torch.fft`` solves, the stencil's gather).
The parameter model is tpumd's:

* Coulomb: the qopt grid loop (set_grid_global :2650, h *= 0.95 over
  compute_qopt_ik :2959), Newton on g_ewald (adjust_gewald :2818) and the
  alias-free Green's function of PPPMDisp::compute_gf (:3691);
* dispersion, geometric mixing: B_i = sqrt(|lj4_ii|) of the atom's type
  (init_coeffs :1409), read on the device from a per-type table; the csum
  moments (calc_csum :3351); with ``kspace_modify disp/auto yes`` the
  bisection for the first g_ewald_6 on the real-space error (set_init_g6
  :3529), the qopt_6 grid (set_n_pppm_6 :3594) and Newton on g_ewald_6
  (adjust_gewald_6 :3462); ``mesh/disp`` and ``gewald/disp`` overrides;
  the dispersion Green's function (compute_gf_6 :3891), its virial
  coefficients (setup :751-791) and the self and volume energy terms
  (compute :1211-1232).

Arithmetic mixing and ``mixflag none`` are not in tpumd and not here; a
barostat raises, as in tpumd.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import erfc as _erfc

from tpumd_torch.models.kspace_pppm import MY_PIS, PPPM, _compute_gf_b, \
    _factorable, _gf_denom, _mesh_k, _powsinxx, _rho_coeff

SMALL = 0.00001


def _qopt_generic(nxyz, prd, order, sfac, kind, g6=None, inv2ew=None):
    """The 5^3-image qopt sweep: compute_qopt_ik (pppm_disp.cpp:2959) and
    compute_qopt_6_ik (:3139), over the whole mesh
    (tpumd/models/kspace_pppm_disp.py:471-525)."""
    nx, ny, nz = nxyz
    (kper, lper, mper), unitk, sqk = _mesh_k(nxyz, prd)
    rtpi = np.sqrt(np.pi)
    four_pi = 4.0 * np.pi
    sum1 = sum2 = sum3 = 0.0
    for ox in range(-2, 3):
        qx = unitk[0] * (kper + nx * ox)
        sx = sfac(qx)
        wx = _powsinxx(0.5 * qx * prd[0] / nx, order)
        for oy in range(-2, 3):
            qy = unitk[1] * (lper + ny * oy)
            sy = sfac(qy)
            wy = _powsinxx(0.5 * qy * prd[1] / ny, order)
            for oz in range(-2, 3):
                qz = unitk[2] * (mper + nz * oz)
                sz = sfac(qz)
                wz = _powsinxx(0.5 * qz * prd[2] / nz, order)
                dot1 = (unitk[0] * kper * qx + unitk[1] * lper * qy
                        + unitk[2] * mper * qz)
                dot2 = qx * qx + qy * qy + qz * qz
                u2 = (wx * wy * wz) ** 2
                s3 = sx * sy * sz
                with np.errstate(divide="ignore", invalid="ignore"):
                    if kind == "coul":
                        safe = np.where(dot2 == 0, 1.0, dot2)
                        sum1 = sum1 + np.where(
                            dot2 > 0, s3 * s3 / safe * four_pi * four_pi,
                            0.0)
                        sum2 = sum2 + np.where(
                            dot2 > 0, u2 * s3 * four_pi / safe * dot1, 0.0)
                    else:
                        rtdot2 = np.sqrt(dot2)
                        term = ((1 - 2 * dot2 * inv2ew * inv2ew) * s3
                                + 2 * dot2 * rtdot2 * inv2ew ** 3
                                * rtpi * _erfc(rtdot2 * inv2ew))
                        term = term * g6 ** 3
                        sum1 = sum1 + term * term * np.pi ** 3 / 9.0 * dot2
                        sum2 = sum2 - u2 * term * np.pi * rtpi / 3.0 * dot1
                sum3 = sum3 + u2
    nonzero = sqk != 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        qopt = np.where(nonzero, sum1 - sum2 * sum2 / np.where(
            nonzero, sum3 * sum3 * sqk, 1.0), 0.0)
    return float(qopt.sum())


class PPPMDisp(PPPM):
    style = "pppm/disp"

    def __init__(self, accuracy_relative: float, order: int = 5,
                 order_6: int = 5):
        super().__init__(accuracy_relative, order)
        self.order_6 = order_6
        self.g_ewald_6 = 1.0
        # kspace_modify disp/auto, mesh/disp, gewald/disp
        self.disp_auto = False
        self.mesh6_override = None
        self.gewald6_override = None

    def init(self, natoms, q, prd, units, cutoff, dynamic_box=False,
             types=None, pair=None):
        if dynamic_box:
            raise NotImplementedError(
                "kspace_style pppm/disp under a barostat is not ported (its "
                "two meshes are set at set-up; tpumd raises too)")
        if pair is None or not hasattr(pair, "lj4") \
                or "lj/long" not in getattr(pair, "name", "") \
                or types is None:
            raise ValueError("kspace_style pppm/disp needs an lj/long pair "
                             f"style, not {getattr(pair, 'name', None)}")
        if not (self.mesh6_override or self.gewald6_override
                or self.disp_auto):
            raise ValueError("pppm/disp without dispersion parameters: use "
                             "kspace_modify disp/auto yes "
                             "(pppm_disp.cpp:352-358)")
        self.cutoff_lj = float(getattr(pair, "cut_lj", None)
                               or pair.cut_global)
        lj4 = np.asarray(pair.lj4, np.float64)
        nt = lj4.shape[0] - 1
        self.b_type = np.sqrt(np.abs(np.diag(lj4)))
        self.b_type[0] = 0.0
        types = np.asarray(types)
        neach = np.bincount(np.clip(types, 0, nt), minlength=nt + 1)
        neach[0] = 0
        b = self.b_type
        self.csum = float(np.sum(neach * b * b))
        self.csumij = float(np.sum(neach * b)) ** 2
        # the Coulomb part: PPPM's init with this class's qopt grid model
        super().init(natoms, q, prd, units, cutoff)
        if self.gewald6_override:
            self.g_ewald_6 = float(self.gewald6_override)
        else:
            self._set_init_g6()
        if self.mesh6_override:
            n6 = [int(v) for v in self.mesh6_override]
            if not all(_factorable(v) for v in n6):
                raise ValueError(f"kspace_modify mesh/disp {n6} is not "
                                 "2/3/5-factorable")
            self.n6 = n6
        else:
            self._set_n_pppm_6()
            for d in range(3):
                while not _factorable(self.n6[d]):
                    self.n6[d] += 1
        if not self.gewald6_override:
            self._adjust_gewald_6()
        self._setup_coeffs_6()
        pair.g_ewald_6 = self.g_ewald_6
        self._dev = {}

    # ------------------------------------------------- Coulomb (qopt) grid
    def _df_kspace(self):
        qopt = _qopt_generic(
            (self.nx, self.ny, self.nz), self.prd, self.order,
            lambda q: np.exp(-0.25 * (q / self.g_ewald) ** 2), "coul")
        return np.sqrt(qopt / self.natoms) * self.q2 / float(
            np.prod(self.prd))

    def _set_grid_global(self, keep_gewald=False):
        """PPPMDisp::set_grid_global (:2650): the g estimate, then the
        qopt loop whatever the differentiation."""
        if not keep_gewald:
            acc = self.accuracy
            g = acc * np.sqrt(self.natoms * self.cutoff
                              * float(np.prod(self.prd))) / (2.0 * self.q2)
            if g >= 1.0:
                raise ValueError("KSpace accuracy too large to estimate G "
                                 "vector")
            self.g_ewald = np.sqrt(-np.log(g)) / self.cutoff
        if self._mesh_from_override():
            return
        n = self._qopt_grid()
        for d in range(3):
            while not _factorable(n[d]):
                n[d] += 1
        self.nx, self.ny, self.nz = n
        self.h = [p / v for p, v in zip(self.prd, n)]

    def _setup_coeffs(self):
        """PPPM's coefficients with PPPMDisp::compute_gf's Green's function
        (:3691): 4 pi/k^2 s W^2 / denom, no alias images."""
        super()._setup_coeffs()
        (kx, ky, kz), unitk, sqk = _mesh_k((self.nx, self.ny, self.nz),
                                           self.prd)
        g = self.g_ewald
        q = (unitk[0] * kx, unitk[1] * ky, unitk[2] * kz)
        s3 = np.exp(-0.25 * ((q[0] / g) ** 2 + (q[1] / g) ** 2
                             + (q[2] / g) ** 2))
        nb = self._nb
        w2 = self._w[0][nb[0]] * self._w[1][nb[1]] * self._w[2][nb[2]]
        with np.errstate(divide="ignore", invalid="ignore"):
            self.greensfn = np.where(
                sqk != 0.0, (4.0 * np.pi / np.where(sqk == 0, 1.0, sqk))
                * s3 * w2 / self._denom, 0.0)

    # ------------------------------------------------ dispersion parameters
    def _lj_rspace_error(self):
        """lj_rspace_error (:3674)."""
        g6 = self.g_ewald_6
        rgs = (self.cutoff_lj * g6) ** 2
        rgs_inv = 1.0 / rgs
        return (self.csum / np.sqrt(self.natoms * float(np.prod(self.prd))
                                    * self.cutoff_lj)
                * np.sqrt(np.pi) * g6 ** 5 * np.exp(-rgs)
                * (1 + rgs_inv * (3 + rgs_inv * (6 + rgs_inv * 6))))

    def _set_init_g6(self):
        """set_init_g6 (:3529): a doubling or halving bracket, then
        bisection on the real-space dispersion error."""
        acc = self.accuracy
        g_old = self.g_ewald_6 = 1.0 / self.cutoff_lj
        df = self._lj_rspace_error() - acc
        counter = 0
        if df > 0:
            while df > 0 and counter < 10000:
                counter += 1
                g_old = self.g_ewald_6
                self.g_ewald_6 *= 2
                df = self._lj_rspace_error() - acc
        if df < 0:
            while df < 0 and counter < 10000:
                counter += 1
                g_old = self.g_ewald_6
                self.g_ewald_6 *= 0.5
                df = self._lj_rspace_error() - acc
        if counter >= 9999:
            raise RuntimeError("Cannot compute initial g_ewald_disp")
        gmin = min(self.g_ewald_6, g_old)
        gmax = max(self.g_ewald_6, g_old)
        self.g_ewald_6 = gmin + 0.5 * (gmax - gmin)
        counter = 0
        while gmax - gmin > SMALL and counter < 10000:
            counter += 1
            if self._lj_rspace_error() - acc < 0:
                gmax = self.g_ewald_6
            else:
                gmin = self.g_ewald_6
            self.g_ewald_6 = gmin + 0.5 * (gmax - gmin)

    def _df_kspace_6(self):
        g6 = self.g_ewald_6
        inv2ew = 1.0 / (2.0 * g6)
        qopt = _qopt_generic(tuple(self.n6), self.prd, self.order_6,
                             lambda q: np.exp(-(q * inv2ew) ** 2), "disp",
                             g6=g6, inv2ew=inv2ew)
        return np.sqrt(qopt / self.natoms) * self.csum / float(
            np.prod(self.prd))

    def _set_n_pppm_6(self):
        """set_n_pppm_6 (:3594): shrink a uniform spacing until qopt_6
        meets the accuracy."""
        hh = 4.0 / self.g_ewald_6
        for _ in range(500):
            self.n6 = [max(int(p / hh), 2) for p in self.prd]
            if self._df_kspace_6() <= self.accuracy:
                return
            hh *= 0.95
        raise RuntimeError("Could not compute grid size for Dispersion")

    def _adjust_gewald_6(self):
        """adjust_gewald_6 (:3462): Newton on the real-space minus the
        k-space dispersion error."""
        def f6():
            return self._lj_rspace_error() - self._df_kspace_6()

        for _ in range(10000):
            f1 = f6()
            h = 0.000001
            g0 = self.g_ewald_6
            self.g_ewald_6 = g0 + h
            f2 = f6()
            self.g_ewald_6 = g0
            self.g_ewald_6 -= f1 / ((f2 - f1) / h)
            if abs(f6()) < SMALL:
                return
        raise RuntimeError("Could not adjust g_ewald_6")

    def _setup_coeffs_6(self):
        """The dispersion mesh's Green's function, virial coefficients and
        assignment polynomials."""
        order = self.order_6
        n = tuple(self.n6)
        (kx, ky, kz), unitk, sqk = _mesh_k(n, self.prd)
        g6 = self.g_ewald_6
        inv2ew = 1.0 / (2.0 * g6)
        rtpi = np.sqrt(np.pi)
        fk = (unitk[0] * kx, unitk[1] * ky, unitk[2] * kz)
        self.fk6 = fk
        denom = _gf_denom(_compute_gf_b(order), [
            np.sin(0.5 * fk[c] * self.prd[c] / n[c]) ** 2 for c in range(3)])
        w = [_powsinxx(0.5 * fk[c] * self.prd[c] / n[c], order) ** 2
             for c in range(3)]
        s3 = np.exp(-(fk[0] * inv2ew) ** 2) * np.exp(-(fk[1] * inv2ew) ** 2) \
            * np.exp(-(fk[2] * inv2ew) ** 2)
        rtsqk = np.sqrt(sqk)
        term = ((1.0 - 2.0 * sqk * inv2ew * inv2ew) * s3
                + 2.0 * sqk * rtsqk * inv2ew ** 3 * rtpi
                * _erfc(rtsqk * inv2ew))
        numerator = -np.pi * rtpi * g6 ** 3 / 3.0
        with np.errstate(divide="ignore", invalid="ignore"):
            self.greensfn_6 = np.where(
                sqk != 0.0, numerator * term * w[0] * w[1] * w[2] / denom,
                0.0)
        b = 0.5 * rtsqk / g6
        bs = b * b
        with np.errstate(divide="ignore", invalid="ignore"):
            nom = 2.0 * bs * b * rtpi * _erfc(b) - 2.0 * bs * np.exp(-bs)
            den = nom + np.exp(-bs)
            safe = np.where(sqk == 0, 1, sqk)
            vterm = np.where(den == 0, 3.0 / safe,
                             3.0 * nom / (safe * np.where(den == 0, 1, den)))
        z = sqk != 0.0
        self.vg_6 = np.stack([
            np.where(z, 1.0 + vterm * fk[0] * fk[0], 0.0),
            np.where(z, 1.0 + vterm * fk[1] * fk[1], 0.0),
            np.where(z, 1.0 + vterm * fk[2] * fk[2], 0.0),
            np.where(z, vterm * fk[0] * fk[1], 0.0),
            np.where(z, vterm * fk[0] * fk[2], 0.0),
            np.where(z, vterm * fk[1] * fk[2], 0.0)])
        self.rho_c6, _ = _rho_coeff(order)

    def _static6(self, dtype, device):
        key = ("disp", dtype, device)
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)
            self._dev[key] = (t(self.greensfn_6), t(self.vg_6),
                              [t(a) for a in self.fk6], t(self.rho_c6),
                              t(self.n6), t(self.b_type))
        return self._dev[key]

    # -------------------------------------------------------------- compute
    def compute(self, x, q, box, eflag: bool, vflag: bool, type_=None):
        f, elong, virial = super().compute(x, q, box, eflag, vflag)
        f6, e6, v6 = self._compute_disp(x, box, type_, eflag, vflag)
        return (f + f6, elong + e6 if eflag else None,
                virial + v6 if vflag else None)

    def _compute_disp(self, x, box, type_, eflag, vflag):
        """The dispersion mesh's forces, energy and virial (ik)."""
        dt_ = x.dtype
        nx, ny, nz = self.n6
        order = self.order_6
        n = x.shape[0]
        ell = box.lengths
        greens, vg, fk, rho_c, dims, b_type = self._static6(dt_, x.device)
        bq = b_type[type_.long()]
        delinv = dims / ell
        flat, w, _ = self._stencil(x, box, (nx, ny, nz), delinv, rho_c,
                                   order)
        w3 = (w[:, :, 2][:, :, None, None] * w[:, :, 1][:, None, :, None]
              * w[:, :, 0][:, None, None, :])
        grid = torch.zeros(nz * ny * nx, dtype=dt_, device=x.device)
        grid.index_add_(0, flat, (bq[:, None, None, None] * w3).reshape(-1))
        rho_k = torch.fft.fftn(grid.reshape(nz, ny, nx))
        phi_k = rho_k * greens
        efield = torch.stack([torch.fft.ifftn(-1j * fk[c] * phi_k).real
                              for c in range(3)], dim=-1).reshape(-1, 3)
        e_at = torch.sum(efield[flat].reshape(n, order ** 3, 3)
                         * w3.reshape(n, order ** 3, 1), dim=1)
        delvol = (ell[0] / nx) * (ell[1] / ny) * (ell[2] / nz)
        f = (bq / delvol)[:, None] * e_at
        elong = virial = None
        if eflag or vflag:
            volume = ell[0] * ell[1] * ell[2]
            rk2 = torch.abs(rho_k) ** 2
            g6 = self.g_ewald_6
            a_corr = np.pi * MY_PIS / (6.0 * volume) * g6 ** 3 * self.csumij
            if eflag:
                elong = (0.5 * torch.sum(greens * rk2) / volume - a_corr
                         + g6 ** 6 * self.csum / 12.0)
            if vflag:
                virial = 0.5 * torch.stack([
                    torch.sum(vg[i] * greens * rk2) for i in range(6)]) \
                    / volume
                virial = virial - a_corr * torch.tensor(
                    [1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=dt_,
                    device=x.device)
        return f, elong, virial
