"""PPPM long-range Coulomb solver (particle-particle particle-mesh) and its
variants: pppm, pppm/cg, pppm/stagger and pppm/tip4p, each with ik or ad
differentiation (``kspace_modify diff``).

PyTorch counterpart of tpumd/models/kspace_pppm.py (the reference's
src/KSPACE/pppm.cpp, pppm_stagger.cpp, pppm_cg.cpp, pppm_tip4p.cpp): the
same parameter model (g_ewald estimate and Newton refinement, per-dimension
ik error with the acons table, or for ad and stagger the qopt error
functional with a shrinking uniform spacing, 2/3/5-factorable mesh sizes;
``kspace_modify`` mesh, order and gewald overrides), order-p B-spline
charge assignment, the Hockney-Eastwood Green's function and the self and
neutralization energy corrections, so mesh sizes and energies match.
Charges are assigned by ``index_add_`` of each atom's order^3 stencil into
the mesh, the Poisson solve is ``torch.fft``, and the field is gathered
back from the same stencil: for ik the three components of -i k phi, for
ad the potential with the derivative weights and the analytic self-force
correction.  pppm/stagger makes two passes, the second on a mesh shifted by
half a cell, and averages them, with the Green's function denominator
averaged between gf_denom and the cosine series gf_denom2.  pppm/cg is
pppm (a zero charge adds nothing to the dense stencil).  pppm/tip4p is
pppm whose positions are the pair style's charge sites: the force
evaluation hands it the sites and spreads the site forces back onto the
atoms (md/verlet.py).  Under a barostat the box-dependent coefficients of
ik (Green's function, virial coefficients, wavevectors) are recomputed
from the box every step, the reference's kspace setup() after each box
change (``dynamic_box``), as one broadcast over the alias images; ad under
a barostat raises, as in tpumd.

tpumd's power-of-two mesh padding (``_fft_safe``) is TPU machinery that
tpumd itself skips on the CPU: the port takes the 2/3/5-factorable sizes.

Across ranks (``mesh``, a run decomposed over a process group,
parallel/mesh.py), pppm spreads each rank's own atoms' charges into the
whole mesh (a rank's halo slots carry no charge here), sums the meshes
with one all-reduce a force evaluation, and every rank runs the same
transforms and reads the field at its own rows; the energy and virial,
which every rank then computes whole, count on rank 0 only.  qsum and
g_ewald come from the set-up's global charges.  The FFT is replicated,
not distributed.
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

# gf_b2[order][l]: the staggered Green's function denominator's cosine
# series (src/KSPACE/pppm_stagger.cpp:59-87; tpumd/models/kspace_pppm.py:
# 111-124): gf_denom2(c) = (sum_l b2[l] c^(2l+1))^2 per dimension
_GF_B2 = {
    1: [1.0],
    2: [5.0 / 6.0, 1.0 / 6.0],
    3: [61.0 / 120.0, 29.0 / 60.0, 1.0 / 120.0],
    4: [277.0 / 1008.0, 1037.0 / 1680.0, 181.0 / 1680.0, 1.0 / 5040.0],
    5: [50521.0 / 362880.0, 7367.0 / 12960.0, 16861.0 / 60480.0,
        1229.0 / 90720.0, 1.0 / 362880.0],
    6: [540553.0 / 7983360.0, 17460701.0 / 39916800.0,
        8444893.0 / 19958400.0, 1409633.0 / 19958400.0,
        44281.0 / 39916800.0, 1.0 / 39916800.0],
    7: [199360981.0 / 6227020800.0, 103867703.0 / 345945600.0,
        66714163.0 / 138378240.0, 54085121.0 / 311351040.0,
        1640063.0 / 138378240.0, 671.0 / 10483200.0, 1.0 / 6227020800.0],
}


def _factorable(n: int) -> bool:
    for f in (2, 3, 5):
        while n % f == 0:
            n //= f
    return n == 1


def _rho_coeff(order: int):
    """compute_rho_coeff: the (order coefficients, order points) tables of
    the assignment polynomials and of their derivatives."""
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
    drho = np.zeros((order, order))
    for m, k in enumerate(range(-(order - 1), order, 2)):
        for l in range(order):
            rho[l][m] = a[l][k + order]
        for l in range(1, order):
            drho[l - 1][m] = l * a[l][k + order]
    return rho, drho


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


def _mesh_k(nxyz, prd):
    """(kper, lper, mper) broadcast on the [z][y][x] mesh, the unit
    wavevectors and |k|^2."""
    nx, ny, nz = nxyz
    k = (_pers(nx)[None, None, :], _pers(ny)[None, :, None],
         _pers(nz)[:, None, None])
    unitk = 2 * np.pi / np.asarray(prd, np.float64)
    sqk = sum((unitk[c] * k[c]) ** 2 for c in range(3))
    return k, unitk, sqk


def _gf_denom(gf_b, sn):
    """gf_denom of the per-dimension sin^2 arguments sn (the product's
    square)."""
    p = [0.0, 0.0, 0.0]
    for l in range(len(gf_b) - 1, -1, -1):
        p = [gf_b[l] + p[c] * sn[c] for c in range(3)]
    return (p[0] * p[1] * p[2]) ** 2


def _gf_denom2(order, cn):
    """pppm/stagger's gf_denom2 of the per-dimension cosines cn."""
    b2 = _GF_B2[order]
    p = [0.0, 0.0, 0.0]
    pw = list(cn)
    for l in range(order):
        p = [p[c] + b2[l] * pw[c] for c in range(3)]
        pw = [pw[c] * cn[c] * cn[c] for c in range(3)]
    return (p[0] * p[1] * p[2]) ** 2


class PPPM:
    style = "pppm"
    mode = "ik"           # kspace_modify diff: "ik" or "ad"
    stagger_flag = False  # pppm/stagger: two interlaced passes

    def __init__(self, accuracy_relative: float, order: int = 5):
        self.accuracy_relative = float(accuracy_relative)
        self.order = order
        self.g_ewald = 0.0
        self.dynamic_box = False
        # kspace_modify mesh nx ny nz and gewald g (KSpace::modify_params)
        self.mesh_override = None
        self.gewald_override = None
        self._dev = {}
        # the process group of a decomposed run (pppm only), else None
        self.mesh = None

    # ---------------------------------------------------------------- init
    def init(self, natoms, q, prd, units, cutoff, dynamic_box=False,
             types=None, pair=None):
        """Mesh, g_ewald and coefficients (PPPM::init): q the host charges,
        prd the box lengths, cutoff the pair style's Coulomb cutoff.
        dynamic_box: a barostat changes the box, so the box-dependent
        coefficients are recomputed every step.  types (the host types)
        and pair (the pair style) are the solver interface's other inputs,
        which the dispersion and TIP4P solvers read."""
        if dynamic_box and self.mode == "ad":
            raise NotImplementedError(
                f"kspace_style {self.style} with kspace_modify diff ad under "
                "a barostat: its Green's function is not recomputed from "
                "the box, as in tpumd; use diff ik")
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
        if self.gewald_override:
            self.g_ewald = float(self.gewald_override)
            self._set_grid_global(keep_gewald=True)
        else:
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

    def _compute_qopt(self):
        """compute_qopt: the ad error functional over the mesh, 5 alias
        images a dimension (tpumd/models/kspace_pppm.py:202-263)."""
        (kper, lper, mper), unitk, sqk = _mesh_k(
            (self.nx, self.ny, self.nz), self.prd)
        n = (self.nx, self.ny, self.nz)
        g = self.g_ewald
        four_pi = 4.0 * np.pi
        sum1 = sum2 = sum3 = sum4 = 0.0
        for ox in range(-2, 3):
            qx = unitk[0] * (kper + n[0] * ox)
            sx = np.exp(-0.25 * (qx / g) ** 2)
            wx = _powsinxx(0.5 * qx * self.prd[0] / n[0], 2 * self.order)
            for oy in range(-2, 3):
                qy = unitk[1] * (lper + n[1] * oy)
                sy = np.exp(-0.25 * (qy / g) ** 2)
                wy = _powsinxx(0.5 * qy * self.prd[1] / n[1], 2 * self.order)
                for oz in range(-2, 3):
                    qz = unitk[2] * (mper + n[2] * oz)
                    sz = np.exp(-0.25 * (qz / g) ** 2)
                    wz = _powsinxx(0.5 * qz * self.prd[2] / n[2],
                                   2 * self.order)
                    dot2 = qx * qx + qy * qy + qz * qz
                    u1 = sx * sy * sz
                    u2 = wx * wy * wz
                    with np.errstate(divide="ignore", invalid="ignore"):
                        sum1 = sum1 + np.where(
                            dot2 > 0, u1 * u1 / np.where(dot2 == 0, 1, dot2)
                            * four_pi * four_pi, 0.0)
                    sum2 = sum2 + u1 * u2 * four_pi
                    sum3 = sum3 + u2
                    sum4 = sum4 + dot2 * u2
        nonzero = sqk != 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            qopt = np.where(nonzero, sum1 - sum2 * sum2 / np.where(
                nonzero, sum3 * sum4, 1.0), 0.0)
        return float(qopt.sum())

    def _compute_qopt_stagger(self):
        """PPPMStagger::compute_qopt (pppm_stagger.cpp:273-372): the
        staggered error functional with the averaged denominator
        (tpumd/models/kspace_pppm.py:265-354)."""
        n = (self.nx, self.ny, self.nz)
        (kper, lper, mper), unitk, sqk = _mesh_k(n, self.prd)
        fk = (unitk[0] * kper, unitk[1] * lper, unitk[2] * mper)
        g = self.g_ewald
        order = self.order
        half = [0.5 * unitk[c] * (kper, lper, mper)[c] * self.prd[c] / n[c]
                for c in range(3)]
        denom = 0.5 * (_gf_denom(_compute_gf_b(order),
                                 [np.sin(h) ** 2 for h in half])
                       + _gf_denom2(order, [np.cos(h) for h in half]))
        nonzero = sqk != 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            numerator = np.where(nonzero, 4.0 * np.pi / np.where(
                nonzero, sqk, 1.0), 0.0)
        sum1 = sum2 = 0.0
        four_pi = 4.0 * np.pi
        for ox in range(-2, 3):
            qx = unitk[0] * (kper + n[0] * ox)
            sx = np.exp(-0.25 * (qx / g) ** 2)
            wx = _powsinxx(0.5 * qx * self.prd[0] / n[0], 2 * order)
            for oy in range(-2, 3):
                qy = unitk[1] * (lper + n[1] * oy)
                sy = np.exp(-0.25 * (qy / g) ** 2)
                wy = _powsinxx(0.5 * qy * self.prd[1] / n[1], 2 * order)
                for oz in range(-2, 3):
                    qz = unitk[2] * (mper + n[2] * oz)
                    sz = np.exp(-0.25 * (qz / g) ** 2)
                    wz = _powsinxx(0.5 * qz * self.prd[2] / n[2], 2 * order)
                    dot1 = fk[0] * qx + fk[1] * qy + fk[2] * qz
                    dot2 = qx * qx + qy * qy + qz * qz
                    u1 = sx * sy * sz
                    u3 = numerator * u1 * (wx * wy * wz) * dot1
                    with np.errstate(divide="ignore", invalid="ignore"):
                        safe = np.where(dot2 == 0, 1.0, dot2)
                        sum1 = sum1 + np.where(
                            dot2 > 0, u1 * u1 * four_pi * four_pi / safe,
                            0.0)
                        sum2 = sum2 + np.where(dot2 > 0, u3 * u3 / safe,
                                               0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            qopt = np.where(nonzero, sum1 - sum2 / np.where(nonzero, denom,
                                                            1.0), 0.0)
        return float(qopt.sum())

    def _df_kspace(self):
        if self.stagger_flag or self.mode == "ad":
            # the qopt functional (pppm.cpp:1015, :1150 gate on
            # differentiation_flag == 1 || stagger_flag)
            qopt = (self._compute_qopt_stagger() if self.stagger_flag
                    else self._compute_qopt())
            return (np.sqrt(qopt / self.natoms) * self.q2
                    / float(np.prod(self.prd)))
        lpr = [self._estimate_ik_error(self.h[d], self.prd[d])
               for d in range(3)]
        return np.sqrt(lpr[0]**2 + lpr[1]**2 + lpr[2]**2) / np.sqrt(3.0)

    def _initial_gewald(self):
        """The g_ewald estimate of set_grid_global."""
        acc = self.accuracy
        g = acc * np.sqrt(self.natoms * self.cutoff
                          * float(np.prod(self.prd))) / (2.0 * self.q2)
        if g >= 1.0:
            return (1.35 - 0.15 * np.log(acc)) / self.cutoff
        return np.sqrt(-np.log(g)) / self.cutoff

    def _mesh_from_override(self) -> bool:
        """kspace_modify mesh (gridflag): the given sizes, which must be
        2/3/5-factorable; False without an override."""
        if not self.mesh_override:
            return False
        n = [int(v) for v in self.mesh_override]
        if not all(_factorable(v) for v in n):
            raise ValueError(f"kspace_modify mesh {n} is not 2/3/5-"
                             "factorable")
        self.nx, self.ny, self.nz = n
        self.h = [p / v for p, v in zip(self.prd, n)]
        return True

    def _qopt_grid(self):
        """The qopt branch of set_grid_global (pppm.cpp:1015-1044): shrink
        a uniform spacing by 0.95 until the error meets the accuracy."""
        hh = 4.0 / self.g_ewald
        for _ in range(500):
            n = [max(int(p / hh), 2) for p in self.prd]
            self.nx, self.ny, self.nz = n
            self.h = [p / v for p, v in zip(self.prd, n)]
            if self._df_kspace() <= self.accuracy:
                return n
            hh *= 0.95
        raise RuntimeError("Could not compute grid size")

    def _set_grid_global(self, keep_gewald=False):
        """set_grid_global: the g_ewald estimate (unless kept), then the
        mesh: the override, the qopt loop (ad, stagger) or per dimension
        the coarsest ik mesh meeting the accuracy, raised to a 2/3/5-
        factorable size."""
        if not keep_gewald:
            self.g_ewald = self._initial_gewald()
        if self._mesh_from_override():
            return
        if self.mode == "ad" or self.stagger_flag:
            n = self._qopt_grid()
        else:
            n = [0, 0, 0]
            h = [1.0 / self.g_ewald] * 3
            for d, prd in enumerate(self.prd):
                n[d] = int(prd / h[d]) + 1
                h[d] = prd / n[d]
                err = self._estimate_ik_error(h[d], prd)
                while err > self.accuracy:
                    err = self._estimate_ik_error(h[d], prd)
                    n[d] += 1
                    h[d] = prd / n[d]
        for d in range(3):
            while not _factorable(n[d]):
                n[d] += 1
        self.nx, self.ny, self.nz = n
        self.h = [p / v for p, v in zip(self.prd, n)]

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
        Green's function denominator (averaged with gf_denom2 for stagger),
        the alias windows, and the static box's Green's function and
        virial coefficients (compute_gf_ik; for ad compute_gf_ad and the
        self-force coefficients)."""
        order = self.order
        nx, ny, nz = self.nx, self.ny, self.nz
        # grid order [z][y][x]
        self._k = (_pers(nx)[None, None, :], _pers(ny)[None, :, None],
                   _pers(nz)[:, None, None])
        arg = [np.pi * k / n for k, n in zip(self._k, (nx, ny, nz))]
        denom = _gf_denom(_compute_gf_b(order),
                          [np.sin(a) ** 2 for a in arg])
        if self.stagger_flag:
            # pppm_stagger.cpp:488-575 compute_gf_ik
            denom = 0.5 * (denom + _gf_denom2(order,
                                              [np.cos(a) for a in arg]))
        self._denom = denom
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
        self.rho_c, self.drho_c = _rho_coeff(order)
        self.nlower = (1 - order) // 2
        self.shiftone = 0.0 if order % 2 else 0.5
        greens, vg, fk = self._box_coeffs(torch.as_tensor(self.prd),
                                          torch.float64)
        self.greensfn, self.vg = greens.numpy(), vg.numpy()
        self.fk = [a.numpy() for a in fk]
        if self.mode == "ad":
            self._setup_ad()

    def _setup_ad(self):
        """compute_gf_ad + compute_sf_precoeff (pppm.cpp:1620-1712;
        tpumd/models/kspace_pppm.py:592-648): the ad Green's function has
        no alias sum, and the self-force coefficients come from 5-image
        sums of the assignment windows (order, not 2 order)."""
        n = (self.nx, self.ny, self.nz)
        (kx, ky, kz), unitk, sqk = _mesh_k(n, self.prd)
        k = (kx, ky, kz)
        g = self.g_ewald
        s = [np.exp(-0.25 * (unitk[c] * k[c] / g) ** 2) for c in range(3)]
        w0 = [_powsinxx(np.pi * k[c] / n[c], 2 * self.order)
              for c in range(3)]
        with np.errstate(divide="ignore", invalid="ignore"):
            self.greensfn = np.where(
                sqk != 0.0, (4.0 * np.pi / np.where(sqk == 0, 1.0, sqk))
                * s[0] * s[1] * s[2] * (w0[0] * w0[1] * w0[2])
                / self._denom, 0.0)

        def wdim(c, off):
            return [_powsinxx(np.pi * (k[c] + n[c] * (i - 2 + off)) / n[c],
                              self.order) for i in range(5)]
        w = [[wdim(c, off) for off in range(3)] for c in range(3)]
        s0 = [sum(a * a for a in w[c][0]) for c in range(3)]
        s01 = [sum(a * b for a, b in zip(w[c][0], w[c][1]))
               for c in range(3)]
        s02 = [sum(a * b for a, b in zip(w[c][0], w[c][2]))
               for c in range(3)]
        pre = [s01[0] * s0[1] * s0[2], s02[0] * s0[1] * s0[2],
               s0[0] * s01[1] * s0[2], s0[0] * s02[1] * s0[2],
               s0[0] * s0[1] * s01[2], s0[0] * s0[1] * s02[2]]
        volume = float(np.prod(self.prd))
        pr = [np.pi / volume * n[c] / self.prd[c] for c in range(3)]
        scale = [pr[0], 2 * pr[0], pr[1], 2 * pr[1], pr[2], 2 * pr[2]]
        self.sf_coeff = [float(np.sum(p * self.greensfn)) * sc
                         for p, sc in zip(pre, scale)]

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
                              t(self.drho_c), t([self.nx, self.ny, self.nz]))
        return self._dev[key]

    # -------------------------------------------------------------- compute
    def compute(self, x, q, box, eflag: bool, vflag: bool, type_=None):
        """(f (N, 3), elong () or None, virial (6,) or None) of the charges
        q at positions x (any rows; padded rows carry q = 0).  type_, the
        rows' types, is the solver interface's input for the dispersion
        solvers.  pppm/stagger averages a pass on the mesh and one on the
        mesh shifted by half a cell (pppm_stagger.cpp:118-235; the self
        and neutralization constants appear once in each pass)."""
        if not self.stagger_flag:
            return self._compute_one(x, q, box, eflag, vflag)
        f0, e0, v0 = self._compute_one(x, q, box, eflag, vflag, 0.0)
        f1, e1, v1 = self._compute_one(x, q, box, eflag, vflag, 0.5)
        return (0.5 * (f0 + f1), None if e0 is None else 0.5 * (e0 + e1),
                None if v0 is None else 0.5 * (v0 + v1))

    @staticmethod
    def _stencil(x, box, n, delinv, rho_c, order, stag=0.0):
        """particle_map and compute_rho1d on the (nx, ny, nz) mesh n: (flat
        mesh index of each atom's order^3 stencil (N * order^3,), the
        weights w (N, order, 3), the fractional distances dxyz (N, 3));
        stag shifts the mesh by that fraction of a cell
        (pppm_stagger.cpp:696-698)."""
        dev = x.device
        gx = (x - box.lo) * delinv + stag
        base = torch.floor(gx + (0.5 if order % 2 else 0.0))
        dxyz = base + (0.0 if order % 2 else 0.5) - gx
        w = torch.stack([PPPM._poly(rho_c[:, pt], dxyz, order)
                         for pt in range(order)], dim=1)
        offs = torch.arange((1 - order) // 2, (1 - order) // 2 + order,
                            device=dev)
        ib = base.to(torch.int64)
        gi = [(ib[:, c, None] + offs) % n[c] for c in range(3)]
        flat = ((gi[2][:, :, None, None] * n[1] + gi[1][:, None, :, None])
                * n[0] + gi[0][:, None, None, :]).reshape(-1)
        return flat, w, dxyz

    @staticmethod
    def _poly(coef, dxyz, nterms):
        acc = torch.zeros_like(dxyz)
        for l in range(nterms - 1, -1, -1):
            acc = coef[l] + acc * dxyz
        return acc

    def _compute_one(self, x, q, box, eflag, vflag, stag: float = 0.0):
        dt_ = x.dtype
        nx, ny, nz = self.nx, self.ny, self.nz
        order = self.order
        n = x.shape[0]
        ell = box.lengths
        greens, vg, fk, rho_c, drho_c, dims = self._static(dt_, x.device)
        if self.dynamic_box:
            greens, vg, fk = self._box_coeffs(ell, dt_)
        delinv = dims / ell
        flat, w, dxyz = self._stencil(x, box, (nx, ny, nz), delinv, rho_c,
                                      order, stag)
        w3 = (w[:, :, 2][:, :, None, None] * w[:, :, 1][:, None, :, None]
              * w[:, :, 0][:, None, None, :])      # (N, order^3)
        # make_rho: one scatter-add of every atom's stencil
        grid = torch.zeros(nz * ny * nx, dtype=dt_, device=x.device)
        grid.index_add_(0, flat, (q[:, None, None, None] * w3).reshape(-1))
        if self.mesh is not None:
            # every rank's charges in the one mesh
            grid = self.mesh.all_reduce(grid)
        rho_k = torch.fft.fftn(grid.reshape(nz, ny, nx))
        phi_k = rho_k * greens
        delvol = (ell[0] / nx) * (ell[1] / ny) * (ell[2] / nz)
        if self.mode == "ad":
            # poisson_ad + fieldforce_ad (pppm.cpp:2150-, 2430-): one
            # inverse transform of the potential, E from the derivative
            # weights, then the analytic self-force correction
            u = torch.fft.ifftn(phi_k).real.reshape(-1)[flat].reshape(
                n, order, order, order)
            dw = torch.stack([self._poly(drho_c[:, pt], dxyz, order - 1)
                              for pt in range(order)], dim=1)
            wz, wy, wx = (w[:, :, 2][:, :, None, None],
                          w[:, :, 1][:, None, :, None],
                          w[:, :, 0][:, None, None, :])
            dwz, dwy, dwx = (dw[:, :, 2][:, :, None, None],
                             dw[:, :, 1][:, None, :, None],
                             dw[:, :, 0][:, None, None, :])
            ek = torch.stack([
                torch.sum(u * (wz * wy * dwx), dim=(1, 2, 3)),
                torch.sum(u * (wz * dwy * wx), dim=(1, 2, 3)),
                torch.sum(u * (dwz * wy * wx), dim=(1, 2, 3))], dim=1)
            f = (q * (self.qqrd2e / delvol))[:, None] * (ek * delinv)
            sf = self.sf_coeff
            s_abs = x * delinv + stag
            two_pi = 2.0 * np.pi
            sfv = torch.stack([
                sf[2 * c] * torch.sin(two_pi * s_abs[:, c])
                + sf[2 * c + 1] * torch.sin(2 * two_pi * s_abs[:, c])
                for c in range(3)], dim=1)
            f = f - self.qqrd2e * 2.0 * (q * q)[:, None] * sfv
        else:
            # poisson_ik: E = -i k phi, three inverse transforms;
            # fieldforce_ik: gather E at the same stencil
            efield = torch.stack([torch.fft.ifftn(-1j * fk[c] * phi_k).real
                                  for c in range(3)], dim=-1).reshape(-1, 3)
            e_at = torch.sum(efield[flat].reshape(n, order ** 3, 3)
                             * w3.reshape(n, order ** 3, 1), dim=1)
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
            if self.mesh is not None and self.mesh.rank != 0:
                # the whole mesh's sums, counted once over the ranks
                elong = None if elong is None else torch.zeros_like(elong)
                virial = None if virial is None else torch.zeros_like(virial)
        return f, elong, virial


class PPPMStagger(PPPM):
    """kspace_style pppm/stagger (src/KSPACE/pppm_stagger.cpp): two
    interlaced assignment meshes half a cell apart and the averaged Green's
    function denominator; ik only, as in tpumd (:976)."""

    style = "pppm/stagger"
    stagger_flag = True

    def init(self, *args, **kwargs):
        if self.mode == "ad":
            raise NotImplementedError(
                "kspace_style pppm/stagger with kspace_modify diff ad is "
                "not taken (tpumd raises too); use diff ik")
        super().init(*args, **kwargs)


class PPPMCG(PPPM):
    """kspace_style pppm/cg accuracy [smallq] (src/KSPACE/pppm_cg.cpp): the
    reference skips atoms with |q| < smallq in its loops; the dense stencil
    adds nothing for a zero charge, so the solver is pppm's."""

    style = "pppm/cg"

    def __init__(self, accuracy_relative, smallq=None, order=5):
        super().__init__(accuracy_relative, order=order)
        self.smallq = 1.0e-5 if smallq is None else float(smallq)


class PPPMTIP4P(PPPM):
    """kspace_style pppm/tip4p (src/KSPACE/pppm_tip4p.cpp): pppm on the
    TIP4P pair style's charge sites, which the force evaluation hands it in
    place of the atoms' positions, their forces spread back onto O and H
    with the pair style's chain rule."""

    style = "pppm/tip4p"

    def init(self, *args, pair=None, **kwargs):
        if not getattr(pair, "is_tip4p", False):
            raise ValueError("kspace_style pppm/tip4p needs a TIP4P pair "
                             f"style, not {getattr(pair, 'name', None)}")
        super().init(*args, pair=pair, **kwargs)
