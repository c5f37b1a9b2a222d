"""PPPM long-range Coulomb solver (particle-particle particle-mesh).

PyTorch counterpart of tpumd/models/kspace_pppm.py (the reference's
src/KSPACE/pppm.cpp) for ik differentiation: the same parameter model
(g_ewald estimate and Newton refinement, per-dimension ik error with the
acons table, 2/3/5-factorable mesh sizes), order-p B-spline charge
assignment, the Hockney-Eastwood Green's function, the ik Poisson solve
and the self and neutralization energy corrections, so mesh sizes and
energies match.  Charges are assigned by ``index_add_`` of each atom's
order^3 stencil into the mesh, the Poisson solve is ``torch.fft``, and the
field is gathered back from the same stencil.  Under a barostat the
box-dependent coefficients (Green's function, virial coefficients,
wavevectors) are recomputed from the box every step, the reference's
kspace setup() after each box change (``dynamic_box``), as one broadcast
over the alias images.

Not ported: pppm/ad, stagger, cg, tip4p and disp; kspace_modify.
"""

from __future__ import annotations

import numpy as np
import torch

MY_PIS = 1.77245385090551602729  # sqrt(pi)
EPS_HOC = 1.0e-7

_ACONS = np.zeros((8, 7))
_ACONS[1][0] = 2.0 / 3.0
_ACONS[2][:2] = [1.0 / 50.0, 5.0 / 294.0]
_ACONS[3][:3] = [1.0 / 588.0, 7.0 / 1440.0, 21.0 / 3872.0]
_ACONS[4][:4] = [1.0 / 4320.0, 3.0 / 1936.0, 7601.0 / 2271360.0,
                 143.0 / 28800.0]
_ACONS[5][:5] = [1.0 / 23232.0, 7601.0 / 13628160.0, 143.0 / 69120.0,
                 517231.0 / 106536960.0, 106640677.0 / 11737571328.0]
_ACONS[6][:6] = [691.0 / 68140800.0, 13.0 / 57600.0, 47021.0 / 35512320.0,
                 9694607.0 / 2095994880.0, 733191589.0 / 59609088000.0,
                 326190917.0 / 11700633600.0]
_ACONS[7][:7] = [1.0 / 345600.0, 3617.0 / 35512320.0, 745739.0 / 838397952.0,
                 56399353.0 / 12773376000.0, 25091609.0 / 1560084480.0,
                 1755948832039.0 / 36229939200000.0,
                 4887769399.0 / 37838389248.0]


def _factorable(n: int) -> bool:
    for f in (2, 3, 5):
        while n % f == 0:
            n //= f
    return n == 1


def _rho_coeff(order: int):
    """compute_rho_coeff: (order coefficients, order points) table of the
    assignment polynomials."""
    a = np.zeros((order, 2 * order + 1))  # a[l][k + order]
    a[0][order] = 1.0
    for j in range(1, order):
        for k in range(-j, j + 1, 2):
            s = 0.0
            for l in range(j):
                a[l + 1][k + order] = (a[l][k + 1 + order]
                                       - a[l][k - 1 + order]) / (l + 1)
                s += (0.5 ** (l + 1)) * (a[l][k - 1 + order] + ((-1.0) ** l)
                                         * a[l][k + 1 + order]) / (l + 1)
            a[0][k + order] = s
    rho = np.zeros((order, order))
    for m, k in enumerate(range(-(order - 1), order, 2)):
        for l in range(order):
            rho[l][m] = a[l][k + order]
    return rho


def _compute_gf_b(order):
    """gf_b denominator coefficients (PPPM::compute_gf_denom)."""
    gf_b = np.zeros(order)
    gf_b[0] = 1.0
    for m in range(1, order):
        for l in range(m, 0, -1):
            gf_b[l] = 4.0 * (gf_b[l] * (l - m) * (l - m - 0.5)
                             - gf_b[l - 1] * (l - m - 1) * (l - m - 1))
        gf_b[0] = 4.0 * (gf_b[0] * (0 - m) * (0 - m - 0.5))
    ifact = 1
    for k in range(1, 2 * order):
        ifact *= k
    return gf_b / ifact


def _powsinxx(arg, n):
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(arg == 0.0, 1.0,
                     np.sin(arg) / np.where(arg == 0, 1, arg))
    return s ** n


def _pers(n):
    """Signed wave numbers of an n-point FFT axis."""
    k = np.arange(n)
    return k - n * (2 * k // n)


class PPPM:
    style = "pppm"

    def __init__(self, accuracy_relative: float, order: int = 5):
        self.accuracy_relative = float(accuracy_relative)
        self.order = order
        self.g_ewald = 0.0
        self.dynamic_box = False
        self._dev = {}

    # ---------------------------------------------------------------- init
    def init(self, natoms, q, prd, units, cutoff, dynamic_box=False):
        """Mesh, g_ewald and coefficients (PPPM::init): q the host charges,
        prd the box lengths, cutoff the pair style's Coulomb cutoff.
        dynamic_box: a barostat changes the box, so the box-dependent
        coefficients are recomputed every step."""
        self.units = units
        self.qqrd2e = units.qqr2e
        q = np.asarray(q, np.float64)
        self.qsum = float(q.sum())
        self.qsqsum = float((q * q).sum())
        self.q2 = self.qsqsum * self.qqrd2e
        self.natoms = natoms
        # two_charge_force (src/kspace.cpp:167)
        self.accuracy = self.accuracy_relative * units.qqr2e
        self.cutoff = float(cutoff)
        self.prd = np.asarray(prd, np.float64)
        self._set_grid_global()
        self._adjust_gewald()
        self._setup_coeffs()
        self.dynamic_box = bool(dynamic_box)
        self._dev = {}

    def _estimate_ik_error(self, h, prd):
        acons = _ACONS[self.order]
        hg = h * self.g_ewald
        ssum = sum(acons[m] * hg ** (2 * m) for m in range(self.order))
        return (self.q2 * hg ** self.order
                * np.sqrt(self.g_ewald * prd * np.sqrt(2 * np.pi)
                          * ssum / self.natoms) / (prd * prd))

    def _df_kspace(self):
        lpr = [self._estimate_ik_error(self.h[d], self.prd[d])
               for d in range(3)]
        return np.sqrt(lpr[0]**2 + lpr[1]**2 + lpr[2]**2) / np.sqrt(3.0)

    def _set_grid_global(self):
        """set_grid_global: g_ewald estimate, then per dimension the
        coarsest mesh meeting the accuracy, raised to a 2/3/5-factorable
        size."""
        xprd, yprd, zprd = self.prd
        acc = self.accuracy
        g = acc * np.sqrt(self.natoms * self.cutoff * xprd * yprd
                          * zprd) / (2.0 * self.q2)
        if g >= 1.0:
            g = (1.35 - 0.15 * np.log(acc)) / self.cutoff
        else:
            g = np.sqrt(-np.log(g)) / self.cutoff
        self.g_ewald = g
        n = [0, 0, 0]
        h = [1.0 / g] * 3
        for d, prd in enumerate(self.prd):
            n[d] = int(prd / h[d]) + 1
            h[d] = prd / n[d]
            err = self._estimate_ik_error(h[d], prd)
            while err > acc:
                err = self._estimate_ik_error(h[d], prd)
                n[d] += 1
                h[d] = prd / n[d]
        for d in range(3):
            while not _factorable(n[d]):
                n[d] += 1
            h[d] = self.prd[d] / n[d]
        self.nx, self.ny, self.nz = n
        self.h = h

    def _newton_f(self):
        df_r = (2.0 * self.q2
                * np.exp(-self.g_ewald**2 * self.cutoff**2)
                / np.sqrt(self.natoms * self.cutoff
                          * self.prd[0] * self.prd[1] * self.prd[2]))
        return df_r - self._df_kspace()

    def _adjust_gewald(self):
        """PPPM::adjust_gewald/derivf literally: the absolute forward
        difference and stopping tolerance, so g_ewald matches bit for
        bit."""
        for _ in range(10000):
            f = self._newton_f()
            h = 0.000001
            g0 = self.g_ewald
            self.g_ewald = g0 + h
            f2 = self._newton_f()
            self.g_ewald = g0
            self.g_ewald -= f / ((f2 - f) / h)
            if abs(self._newton_f()) < 0.00001:
                return
        raise RuntimeError("Could not compute g_ewald")

    def _setup_coeffs(self):
        """Box-independent coefficients: the assignment polynomials, the
        Green's function denominator, the alias windows, and the static
        box's Green's function and virial coefficients (compute_gf_ik)."""
        order = self.order
        nx, ny, nz = self.nx, self.ny, self.nz
        gf_b = _compute_gf_b(order)
        # grid order [z][y][x]
        self._k = (_pers(nx)[None, None, :], _pers(ny)[None, :, None],
                   _pers(nz)[:, None, None])
        kx, ky, kz = self._k

        def poly(s):
            p = 0.0
            for l in range(order - 1, -1, -1):
                p = gf_b[l] + p * s
            return p
        sn = [np.sin(np.pi * k / n) ** 2 for k, n in zip(self._k,
                                                          (nx, ny, nz))]
        s = poly(sn[0]) * poly(sn[1]) * poly(sn[2])
        self._denom = s * s
        nb = [int((self.g_ewald * p / (np.pi * n))
                  * (-np.log(EPS_HOC)) ** 0.25)
              for p, n in zip(self.prd, (nx, ny, nz))]
        self._nb = nb
        # alias images m = k + n o, o in [-nb, nb], along a leading axis;
        # w(o) = powsinxx(pi m / n, 2 order) depends on the mesh only
        self._m = [k[None] + n * np.arange(-b, b + 1).reshape(
            (-1,) + (1,) * 3) for k, n, b in zip(self._k, (nx, ny, nz), nb)]
        self._w = [_powsinxx(np.pi * m / n, 2 * order)
                   for m, n in zip(self._m, (nx, ny, nz))]
        self.rho_c = _rho_coeff(order)
        self.nlower = (1 - order) // 2
        self.shiftone = 0.0 if order % 2 else 0.5
        greens, vg, fk = self._box_coeffs(torch.as_tensor(self.prd),
                                          torch.float64)
        self.greensfn, self.vg = greens.numpy(), vg.numpy()
        self.fk = [a.numpy() for a in fk]

    def _box_coeffs(self, ell, dtype):
        """(greens, vg (6, ...), (fkx, fky, fkz)) for box lengths ell, as
        tensors on ell's device: compute_gf_ik and the virial
        coefficients (pppm.cpp:452-465), the alias sum as one broadcast
        over (2 nbx + 1)(2 nby + 1)(2 nbz + 1) images."""
        dev = ell.device
        key = (dtype, dev)
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=dev)
            self._dev[key] = ([t(k) for k in self._k],
                              [t(m) for m in self._m],
                              [t(w) for w in self._w], t(self._denom))
        k, m, w, denom = self._dev[key]
        g = self.g_ewald
        unit = 2.0 * np.pi / ell.to(dtype)
        fk = [unit[c] * k[c] for c in range(3)]
        sqk = fk[0] * fk[0] + fk[1] * fk[1] + fk[2] * fk[2]
        # per axis over its images: q = unit * m, sw = exp(-q^2/4g^2) w
        qa = [unit[c] * m[c] for c in range(3)]
        sw = [torch.exp(-0.25 * (qc / g) ** 2) * wc for qc, wc in zip(qa, w)]
        qx = qa[0][:, None, None]
        qy = qa[1][None, :, None]
        qz = qa[2][None, None, :]
        dot1 = fk[0] * qx + fk[1] * qy + fk[2] * qz
        dot2 = qx * qx + qy * qy + qz * qz
        term = torch.where(dot2 > 0, dot1 / torch.where(dot2 == 0, 1.0, dot2),
                           0.0)
        sum1 = torch.sum(term * sw[0][:, None, None] * sw[1][None, :, None]
                         * sw[2][None, None, :], dim=(0, 1, 2))
        nonzero = sqk != 0.0
        safe = torch.where(nonzero, sqk, 1.0)
        greens = torch.where(nonzero, (4.0 * np.pi / safe) * sum1 / denom,
                             0.0)
        vterm = torch.where(nonzero, -2.0 * (1.0 / safe + 0.25 / (g * g)),
                            0.0)
        vg = torch.stack([
            torch.where(nonzero, 1.0 + vterm * fk[0] * fk[0], 0.0),
            torch.where(nonzero, 1.0 + vterm * fk[1] * fk[1], 0.0),
            torch.where(nonzero, 1.0 + vterm * fk[2] * fk[2], 0.0),
            torch.where(nonzero, vterm * fk[0] * fk[1], 0.0),
            torch.where(nonzero, vterm * fk[0] * fk[2], 0.0),
            torch.where(nonzero, vterm * fk[1] * fk[2], 0.0)])
        return greens, vg, fk

    def _static(self, dtype, device):
        key = ("static", dtype, device)
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)
            self._dev[key] = (t(self.greensfn), t(self.vg),
                              [t(a) for a in self.fk], t(self.rho_c),
                              t([self.nx, self.ny, self.nz]))
        return self._dev[key]

    # -------------------------------------------------------------- compute
    def compute(self, x, q, box, eflag: bool, vflag: bool):
        """(f (N, 3), elong () or None, virial (6,) or None) of the charges
        q at positions x (any rows; padded rows carry q = 0)."""
        dt_ = x.dtype
        dev = x.device
        nx, ny, nz = self.nx, self.ny, self.nz
        order = self.order
        n = x.shape[0]
        ell = box.lengths
        greens, vg, fk, rho_c, dims = self._static(dt_, dev)
        if self.dynamic_box:
            greens, vg, fk = self._box_coeffs(ell, dt_)
        delinv = dims / ell
        # particle_map: for odd order the nearest grid point (shift 0.5)
        gx = (x - box.lo) * delinv
        base = torch.floor(gx + (0.5 if order % 2 else 0.0))
        dxyz = base + self.shiftone - gx           # (N, 3)
        # compute_rho1d: w[:, k, c] is the weight of stencil point k
        pts = []
        for pt in range(order):
            acc = torch.zeros_like(dxyz)
            for l in range(order - 1, -1, -1):
                acc = rho_c[l, pt] + acc * dxyz
            pts.append(acc)
        w = torch.stack(pts, dim=1)                # (N, order, 3)
        offs = torch.arange(self.nlower, self.nlower + order, device=dev)
        ib = base.to(torch.int64)
        gz = (ib[:, 2, None] + offs) % nz         # (N, order)
        gy = (ib[:, 1, None] + offs) % ny
        gxi = (ib[:, 0, None] + offs) % nx
        flat = ((gz[:, :, None, None] * ny + gy[:, None, :, None]) * nx
                + gxi[:, None, None, :]).reshape(-1)
        w3 = (w[:, :, 2][:, :, None, None] * w[:, :, 1][:, None, :, None]
              * w[:, :, 0][:, None, None, :])      # (N, order^3)
        # make_rho: one scatter-add of every atom's stencil
        grid = torch.zeros(nz * ny * nx, dtype=dt_, device=dev)
        grid.index_add_(0, flat, (q[:, None, None, None] * w3).reshape(-1))
        rho_k = torch.fft.fftn(grid.reshape(nz, ny, nx))
        phi_k = rho_k * greens
        # poisson_ik: E = -i k phi, three inverse transforms
        efield = torch.stack([torch.fft.ifftn(-1j * fk[c] * phi_k).real
                              for c in range(3)], dim=-1).reshape(-1, 3)
        # fieldforce_ik: gather E at the same stencil
        e_at = torch.sum(efield[flat].reshape(n, order ** 3, 3)
                         * w3.reshape(n, order ** 3, 1), dim=1)
        delvol = (ell[0] / nx) * (ell[1] / ny) * (ell[2] / nz)
        f = (q * (self.qqrd2e / delvol))[:, None] * e_at
        elong = virial = None
        if eflag or vflag:
            volume = ell[0] * ell[1] * ell[2]
            rk2 = torch.abs(rho_k) ** 2
            if eflag:
                e = 0.5 * torch.sum(greens * rk2) / volume
                e = (e - self.g_ewald * self.qsqsum / MY_PIS
                     - 0.5 * np.pi * self.qsum ** 2
                     / (self.g_ewald ** 2 * volume))
                elong = self.qqrd2e * e
            if vflag:
                gr = greens * rk2
                virial = 0.5 * self.qqrd2e * torch.stack([
                    torch.sum(vg[i] * gr) for i in range(6)]) / volume
        return f, elong, virial
