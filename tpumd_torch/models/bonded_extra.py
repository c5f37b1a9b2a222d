"""EXTRA-MOLECULE bonded styles (src/EXTRA-MOLECULE/*.cpp), the port's copy
of tpumd/models/bonded_extra.py:

bonds    : fene/nm, gaussian, harmonic/shift, harmonic/shift/cut
angles   : cosine/delta, cosine/shift, cosine/shift/exp, fourier,
           fourier/simple, gaussian
dihedrals: fourier, helix, nharmonic, quadratic, cosine/shift/exp
impropers: cossq, fourier, ring, distance

Each 3- and 4-body style states the reference's per-tuple energy and
takes its forces as minus the gradient (bonded_class2.grad_terms), except
angle cosine/delta and improper cossq, whose reference forces are not the
gradient of their energies and are written out as the reference computes
them.  The bond styles are analytic (bond_fn).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.models.bonded import AngleStyle, BondStyle, \
    DihedralStyle, ImproperStyle
from tpumd_torch.models.bonded_class2 import DEG2RAD, EnergyStyle, \
    _EPS, cos_angle, safe_r, signed_phi
from tpumd_torch.models.registry import register_bonded


def _zeros(ntypes):
    return np.zeros(ntypes + 1)


def _packed_terms(terms, nrows, fill=(0.0, 1.0, 0.0)):
    """(nrows, nmax) tables of each column of the per-type term lists
    ({type: (n, ncol)}), padded with fill per column (a zero-weight term
    of width 1)."""
    nmax = max(v.shape[0] for v in terms.values())
    ncol = next(iter(terms.values())).shape[1]
    out = [np.full((nrows, nmax), fill[c]) for c in range(ncol)]
    for t, v in terms.items():
        for c in range(ncol):
            out[c][t, :len(v)] = v[:, c]
    return out


# ------------------------------------------------------------------ bonds
@register_bonded("bond", "fene/nm")
class BondFENENM(BondStyle):
    """FENE backbone + generalized n-m repulsive core
    (src/EXTRA-MOLECULE/bond_fene_nm.cpp:60-110)."""

    name = "fene/nm"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k, self.r0 = _zeros(ntypes), _zeros(ntypes)
        self.epsilon, self.sigma = _zeros(ntypes), _zeros(ntypes)
        self.nn, self.mm = _zeros(ntypes) + 2, _zeros(ntypes) + 1

    def coeff(self, btype, k, r0, eps, sigma, n, m):
        self.k[btype], self.r0[btype] = k, r0
        self.epsilon[btype], self.sigma[btype] = eps, sigma
        self.nn[btype], self.mm[btype] = n, m

    def bond_fn(self, r2, btype):
        k, r0, eps, sig, nn, mm = (self.per(a, r2, btype) for a in (
            self.k, self.r0, self.epsilon, self.sigma, self.nn, self.mm))
        r0sq = r0 * r0
        rlog = torch.clamp(1.0 - r2 / r0sq, min=0.02)
        fbond = -k / rlog
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        inside = r2 < sig * sig
        sr = torch.where(inside, sig / r, 1.0)
        srn = sr ** nn
        srm = sr ** mm
        fbond = fbond + torch.where(
            inside, eps * (nn * mm / (nn - mm)) * (srn - srm) / r2, 0.0)
        e = -0.5 * k * r0sq * torch.log(rlog)
        e = e + torch.where(inside,
                            (eps / (nn - mm)) * (mm * srn - nn * srm), 0.0)
        return fbond, e


class _Boltzmann:
    """Styles whose energy carries kB T: kB from the deck's units."""

    def init(self):
        super().init()
        u = getattr(self, "units", None)
        self._boltz = u.boltz if u is not None else 1.0


@register_bonded("bond", "gaussian")
class BondGaussian(_Boltzmann, BondStyle):
    """Multi-gaussian inverse-Boltzmann bond
    (src/EXTRA-MOLECULE/bond_gaussian.cpp:61-120):
    E = -kB T ln sum_i [A_i/(w_i sqrt(pi/2)) exp(-2 (r-r_i)^2/w_i^2)]."""

    name = "gaussian"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.temp = _zeros(ntypes)
        self.terms = {}   # type -> (n, 3): alpha, width, r0

    def coeff(self, btype, temp, n, *rest):
        n = int(n)
        self.temp[btype] = temp
        self.terms[btype] = np.asarray(rest[:3 * n],
                                       np.float64).reshape(n, 3)

    def init(self):
        super().init()
        self._packed = _packed_terms(self.terms, self.ntypes + 1)

    def bond_fn(self, r2, btype):
        alpha, width, r0 = (self.per(a, r2, btype) for a in self._packed)
        r = torch.sqrt(torch.clamp(r2, min=1e-30))[:, None]
        dr = r - r0
        pref = alpha / (width * np.sqrt(np.pi / 2.0))
        g = pref * torch.exp(-2.0 * dr * dr / (width * width))
        sum_g = torch.sum(g, -1)
        sum_num = torch.sum(g * dr / (width * width), -1)
        sum_g = torch.maximum(sum_g, torch.abs(sum_num) * 1e-10 + 1e-300)
        kt = self._boltz * self.per(self.temp, r2, btype)
        fbond = -4.0 * kt * (sum_num / sum_g) / r[:, 0]
        return fbond, -kt * torch.log(sum_g)


@register_bonded("bond", "harmonic/shift")
class BondHarmonicShift(BondStyle):
    """E = Umin/(r0-rc)^2 [(r-r0)^2 - (rc-r0)^2]
    (src/EXTRA-MOLECULE/bond_harmonic_shift.cpp; k = Umin/(r0-rc)^2)."""

    name = "harmonic/shift"
    _cut = False

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = _zeros(ntypes)
        self.r0 = _zeros(ntypes)
        self.r1 = np.ones(ntypes + 1)

    def coeff(self, btype, umin, r0, rc):
        self.k[btype] = umin / ((r0 - rc) * (r0 - rc))
        self.r0[btype] = r0
        self.r1[btype] = rc

    def bond_fn(self, r2, btype):
        k, r0, r1 = (self.per(a, r2, btype) for a in (self.k, self.r0,
                                                       self.r1))
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        dr = r - r0
        live = (r <= r1) if self._cut else torch.ones_like(r, dtype=bool)
        fbond = torch.where(live, -2.0 * k * dr / r, 0.0)
        e = torch.where(live, k * (dr * dr - (r0 - r1) * (r0 - r1)), 0.0)
        return fbond, e


@register_bonded("bond", "harmonic/shift/cut")
class BondHarmonicShiftCut(BondHarmonicShift):
    """harmonic/shift with the interaction cut at rc
    (src/EXTRA-MOLECULE/bond_harmonic_shift_cut.cpp:76)."""

    name = "harmonic/shift/cut"
    _cut = True


# ----------------------------------------------------------------- angles
def _cs(xs, box):
    """(cos, sin) of angles 1-2-3, guarded for the gradient."""
    d1 = minimum_image(xs[0] - xs[1], box)
    d2 = minimum_image(xs[2] - xs[1], box)
    c = cos_angle(d1, d2, safe_r(d1), safe_r(d2))
    return c, torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24))


@register_bonded("angle", "cosine/delta")
class AngleCosineDelta(AngleStyle):
    """E = K [1 - cos(theta - theta0)]
    (src/EXTRA-MOLECULE/angle_cosine_delta.cpp).  The reference's force is
    not the gradient of E: its cot is computed after s was inverted
    (:90-94, cot = c sin(theta)); the port computes it so."""

    name = "cosine/delta"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = _zeros(ntypes)
        self.theta0 = _zeros(ntypes)

    def coeff(self, atype, k, theta0):
        self.k[atype] = k
        self.theta0[atype] = theta0 * DEG2RAD

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        d1 = minimum_image(xs[0] - xs[1], box)
        d2 = minimum_image(xs[2] - xs[1], box)
        rsq1 = torch.sum(d1 * d1, -1)
        rsq2 = torch.sum(d2 * d2, -1)
        r1, r2 = safe_r(d1), safe_r(d2)
        c = cos_angle(d1, d2, r1, r2)
        sv = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24))
        cot = c * sv
        k = self.per(self.k, c, ttype)
        t0 = self.per(self.theta0, c, ttype)
        a = -k
        a11 = a * c / rsq1
        a12 = -a / (r1 * r2)
        a22 = a * c / rsq2
        b11 = -a * c * cot / rsq1
        b12 = a * cot / (r1 * r2)
        b22 = -a * c * cot / rsq2
        c0 = torch.cos(t0)
        s0 = torch.sin(t0)
        f1 = ((a11 * c0 + b11 * s0)[:, None] * d1
              + (a12 * c0 + b12 * s0)[:, None] * d2)
        f3 = ((a22 * c0 + b22 * s0)[:, None] * d2
              + (a12 * c0 + b12 * s0)[:, None] * d1)
        f2 = -(f1 + f3)
        e = k * (1.0 - torch.cos(torch.arccos(c) - t0))
        return ([f1, f2, f3], {self.energy_key: e} if eflag else None,
                [(d1, f1), (d2, f3)] if vflag else None)


@register_bonded("angle", "cosine/shift")
class AngleCosineShift(EnergyStyle, AngleStyle):
    """E = -Umin/2 [1 + cos(theta - theta0)]
    (src/EXTRA-MOLECULE/angle_cosine_shift.cpp: the kcos/ksin split)."""

    name = "cosine/shift"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.khalf, self.kcos = _zeros(ntypes), _zeros(ntypes)
        self.ksin, self.theta0 = _zeros(ntypes), _zeros(ntypes)

    def coeff(self, atype, umin, theta0):
        self.khalf[atype] = umin / 2.0
        self.kcos[atype] = umin / 2.0 * np.cos(theta0 * DEG2RAD)
        self.ksin[atype] = umin / 2.0 * np.sin(theta0 * DEG2RAD)
        self.theta0[atype] = theta0 * DEG2RAD

    def _energy(self, xs, ttype, box):
        c, s = _cs(xs, box)
        return (-self.per(self.khalf, c, ttype)
                - self.per(self.kcos, c, ttype) * c
                - self.per(self.ksin, c, ttype) * s)


def _shift_exp(self, c, s, ttype):
    """-Umin [e^{-a U} - 1]/[e^a - 1], U = -0.5(1 + cos(t - t0)), with the
    |a| < 0.001 series branch (angle_cosine_shift_exp.cpp:128-140)."""
    ccc = c * self.per(self.cost, c, ttype) + s * self.per(self.sint, c,
                                                           ttype)
    aa, uumin = self.per(self.a, c, ttype), self.per(self.umin, c, ttype)
    e_series = -0.125 * (1 + ccc) * (4 + aa * (ccc - 1)) * uumin
    e_exp = self.per(self.opt1, c, ttype) * (1 - torch.exp(0.5 * aa
                                                           * (1 + ccc)))
    return torch.where(self.table(self.do_exp, c, torch.bool)[ttype],
                       e_series, e_exp)


class _ShiftExp:
    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.umin, self.a, self.cost = (_zeros(ntypes), _zeros(ntypes),
                                        _zeros(ntypes))
        self.sint, self.theta0, self.opt1 = (_zeros(ntypes), _zeros(ntypes),
                                             _zeros(ntypes))
        self.do_exp = np.ones(ntypes + 1, bool)

    def coeff(self, ttype, umin, theta0, a):
        self.umin[ttype], self.a[ttype] = umin, a
        self.cost[ttype] = np.cos(theta0 * DEG2RAD)
        self.sint[ttype] = np.sin(theta0 * DEG2RAD)
        self.theta0[ttype] = theta0 * DEG2RAD
        self.do_exp[ttype] = abs(a) < 0.001
        if not self.do_exp[ttype]:
            self.opt1[ttype] = umin / (np.exp(a) - 1.0)


@register_bonded("angle", "cosine/shift/exp")
class AngleCosineShiftExp(_ShiftExp, EnergyStyle, AngleStyle):
    """E = -Umin [e^{-a U} - 1]/[e^a - 1], U = -0.5(1+cos(theta-theta0))
    (src/EXTRA-MOLECULE/angle_cosine_shift_exp.cpp:128-140,215)."""

    name = "cosine/shift/exp"

    def _energy(self, xs, ttype, box):
        c, s = _cs(xs, box)
        return _shift_exp(self, c, s, ttype)


@register_bonded("angle", "fourier")
class AngleFourier(EnergyStyle, AngleStyle):
    """E = K [C0 + C1 cos(theta) + C2 cos(2 theta)]
    (src/EXTRA-MOLECULE/angle_fourier.cpp)."""

    name = "fourier"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k, self.c0 = _zeros(ntypes), _zeros(ntypes)
        self.c1, self.c2 = _zeros(ntypes), _zeros(ntypes)

    def coeff(self, atype, k, c0, c1, c2):
        self.k[atype], self.c0[atype] = k, c0
        self.c1[atype], self.c2[atype] = c1, c2

    def _energy(self, xs, ttype, box):
        c, _ = _cs(xs, box)

        def p(t):
            return self.per(t, c, ttype)
        return p(self.k) * (p(self.c0) + p(self.c1) * c
                            + p(self.c2) * (2.0 * c * c - 1.0))


@register_bonded("angle", "fourier/simple")
class AngleFourierSimple(EnergyStyle, AngleStyle):
    """E = K [1 + C cos(N theta)]
    (src/EXTRA-MOLECULE/angle_fourier_simple.cpp)."""

    name = "fourier/simple"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k, self.C, self.N = (_zeros(ntypes), _zeros(ntypes),
                                  _zeros(ntypes))

    def coeff(self, atype, k, c, n):
        self.k[atype], self.C[atype], self.N[atype] = k, c, n

    def _energy(self, xs, ttype, box):
        c, _ = _cs(xs, box)
        th = torch.arccos(c)

        def p(t):
            return self.per(t, c, ttype)
        return p(self.k) * (1.0 + p(self.C) * torch.cos(p(self.N) * th))


@register_bonded("angle", "gaussian")
class AngleGaussian(_Boltzmann, EnergyStyle, AngleStyle):
    """E = -kB T ln sum_i [A_i/(w_i sqrt(pi/2)) exp(-2 dth^2/w_i^2)]
    (src/EXTRA-MOLECULE/angle_gaussian.cpp)."""

    name = "gaussian"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.temp = _zeros(ntypes)
        self.terms = {}   # type -> (n, 3): alpha, width, theta0 (rad)

    def coeff(self, atype, temp, n, *rest):
        n = int(n)
        vals = np.asarray(rest[:3 * n], np.float64).reshape(n, 3)
        vals[:, 2] *= DEG2RAD
        self.temp[atype] = temp
        self.terms[atype] = vals

    def init(self):
        super().init()
        self._packed = _packed_terms(self.terms, self.ntypes + 1)

    def _energy(self, xs, ttype, box):
        c, _ = _cs(xs, box)
        th = torch.arccos(c)[:, None]
        alpha, width, t0 = (self.per(a, c, ttype) for a in self._packed)
        dth = th - t0
        pref = alpha / (width * np.sqrt(np.pi / 2.0))
        g = pref * torch.exp(-2.0 * dth * dth / (width * width))
        sum_g = torch.clamp(torch.sum(g, -1), min=1e-300)
        kt = self._boltz * self.per(self.temp, c, ttype)
        return -kt * torch.log(sum_g)


# -------------------------------------------------------------- dihedrals
def _phi(xs, box):
    vb1 = minimum_image(xs[0] - xs[1], box)
    vb2 = minimum_image(xs[2] - xs[1], box)
    vb3 = minimum_image(xs[3] - xs[2], box)
    return signed_phi(vb1, vb2, vb3, safe_r(vb2))


@register_bonded("dihedral", "fourier")
class DihedralFourier(EnergyStyle, DihedralStyle):
    """E = sum_j K_j [1 + cos(n_j phi - d_j)]
    (src/EXTRA-MOLECULE/dihedral_fourier.cpp)."""

    name = "fourier"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.terms = {}   # type -> (m, 3): K, n, d (rad)

    def coeff(self, dtype_, m, *rest):
        m = int(m)
        vals = np.asarray(rest[:3 * m], np.float64).reshape(m, 3)
        vals[:, 2] *= DEG2RAD
        self.terms[dtype_] = vals

    def init(self):
        super().init()
        self._packed = _packed_terms(self.terms, self.ntypes + 1,
                                     (0.0, 0.0, 0.0))

    def _energy(self, xs, ttype, box):
        phi = _phi(xs, box)[:, None]
        k, n, d = (self.per(a, phi, ttype) for a in self._packed)
        return torch.sum(k * (1.0 + torch.cos(n * phi - d)), -1)


@register_bonded("dihedral", "helix")
class DihedralHelix(EnergyStyle, DihedralStyle):
    """E = A(1-cos phi) + B(1+cos 3phi) + C(1+cos(phi+pi/4))
    (src/EXTRA-MOLECULE/dihedral_helix.cpp:130-133)."""

    name = "helix"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.aphi, self.bphi, self.cphi = (_zeros(ntypes), _zeros(ntypes),
                                           _zeros(ntypes))

    def coeff(self, dtype_, a, b, c):
        self.aphi[dtype_], self.bphi[dtype_], self.cphi[dtype_] = a, b, c

    def _energy(self, xs, ttype, box):
        phi = _phi(xs, box)

        def p(t):
            return self.per(t, phi, ttype)
        return (p(self.aphi) * (1.0 - torch.cos(phi))
                + p(self.bphi) * (1.0 + torch.cos(3.0 * phi))
                + p(self.cphi) * (1.0 + torch.cos(phi + np.pi / 4.0)))


@register_bonded("dihedral", "nharmonic")
class DihedralNHarmonic(EnergyStyle, DihedralStyle):
    """E = sum_n A_n cos^{n-1}(phi)
    (src/EXTRA-MOLECULE/dihedral_nharmonic.cpp)."""

    name = "nharmonic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.terms = {}

    def coeff(self, dtype_, n, *rest):
        self.terms[dtype_] = np.asarray(rest[:int(n)], np.float64)

    def init(self):
        super().init()
        self._packed = _packed_terms(
            {t: v[:, None] for t, v in self.terms.items()},
            self.ntypes + 1, (0.0,))[0]

    def _energy(self, xs, ttype, box):
        c = torch.cos(_phi(xs, box))[:, None]
        a = self.per(self._packed, c, ttype)
        pows = c ** torch.arange(a.shape[-1], dtype=c.dtype,
                                 device=c.device)
        return torch.sum(a * pows, -1)


@register_bonded("dihedral", "quadratic")
class DihedralQuadratic(EnergyStyle, DihedralStyle):
    """E = K (phi - phi0)^2 with dphi wrapped into (-pi, pi]
    (src/EXTRA-MOLECULE/dihedral_quadratic.cpp:126-133)."""

    name = "quadratic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = _zeros(ntypes)
        self.phi0 = _zeros(ntypes)

    def coeff(self, dtype_, k, phi0):
        self.k[dtype_] = k
        self.phi0[dtype_] = phi0 * DEG2RAD

    def _energy(self, xs, ttype, box):
        phi = _phi(xs, box)
        dphi = phi - self.per(self.phi0, phi, ttype)
        dphi = torch.where(dphi > np.pi, dphi - 2 * np.pi, dphi)
        dphi = torch.where(dphi < -np.pi, dphi + 2 * np.pi, dphi)
        return self.per(self.k, phi, ttype) * dphi * dphi


@register_bonded("dihedral", "cosine/shift/exp")
class DihedralCosineShiftExp(_ShiftExp, EnergyStyle, DihedralStyle):
    """E = -Umin [e^{-a U} - 1]/[e^a - 1], U = -0.5(1+cos(phi-theta0))
    (src/EXTRA-MOLECULE/dihedral_cosine_shift_exp.cpp:150-160)."""

    name = "cosine/shift/exp"

    def _energy(self, xs, ttype, box):
        phi = _phi(xs, box)
        return _shift_exp(self, torch.cos(phi), torch.sin(phi), ttype)


# -------------------------------------------------------------- impropers
class _EnergyImproper(EnergyStyle, ImproperStyle):
    def _virial_vectors(self, xs, box):
        """x1 - x2, x3 - x2 and x4 - x2 with the forces on members 1, 3
        and 4."""
        return [(minimum_image(xs[k] - xs[1], box), k) for k in (0, 2, 3)]


@register_bonded("improper", "cossq")
class ImproperCossq(_EnergyImproper):
    """E = 0.5 K cos^2(tau - chi0), tau the angle between bond 1->2 and
    bond 3->4 (src/EXTRA-MOLECULE/improper_cossq.cpp:100-130).  The
    reference's force is not the gradient for chi != 0: angfac = -K
    cos(tau - chi) multiplies d(cos tau)/dx with no acos chain factor
    (:150-200); the port computes it so."""

    name = "cossq"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = _zeros(ntypes)
        self.chi = _zeros(ntypes)

    def coeff(self, itype, k, chi):
        self.k[itype] = k
        self.chi[itype] = chi * DEG2RAD

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        vb1 = minimum_image(xs[1] - xs[0], box)
        vb3 = minimum_image(xs[3] - xs[2], box)
        rjisq = torch.clamp(torch.sum(vb1 * vb1, -1), min=1e-30)
        rlksq = torch.clamp(torch.sum(vb3 * vb3, -1), min=1e-30)
        clkji = torch.sum(vb3 * vb1, -1)
        c = torch.clamp(clkji / torch.sqrt(rjisq * rlksq),
                        -1.0 + _EPS, 1.0 - _EPS)
        k = self.per(self.k, c, ttype)
        cc = torch.cos(torch.arccos(c) - self.per(self.chi, c, ttype))
        e = 0.5 * k * cc * cc
        cfact1 = -k * cc / torch.sqrt(rlksq * rjisq)
        cfact2 = clkji / rlksq
        cfact3 = clkji / rjisq
        f1 = cfact1[:, None] * (-vb3 + cfact3[:, None] * vb1)
        f3 = cfact1[:, None] * (cfact2[:, None] * vb3 - vb1)
        fs = [f1, -f1, f3, -f3]
        vp = None
        if vflag:
            vp = [(r, fs[k]) for r, k in self._virial_vectors(xs, box)]
        return fs, {self.energy_key: e} if eflag else None, vp


@register_bonded("improper", "fourier")
class ImproperFourier(_EnergyImproper):
    """E = K [C0 + C1 cos(omega) + C2 cos(2 omega)], omega between the
    IL axis and the IJK plane; ``all`` adds the two permuted terms
    (src/EXTRA-MOLECULE/improper_fourier.cpp addone)."""

    name = "fourier"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k, self.c0 = _zeros(ntypes), _zeros(ntypes)
        self.c1, self.c2 = _zeros(ntypes), _zeros(ntypes)
        self.all = np.zeros(ntypes + 1, np.int32)

    def coeff(self, itype, k, c0, c1, c2, all_flag=0):
        self.k[itype], self.c0[itype] = k, c0
        self.c1[itype], self.c2[itype] = c1, c2
        self.all[itype] = int(all_flag)

    def _one(self, vb1, vb2, vb3, ttype):
        # c is against the IJK plane's normal; the energy takes cos(omega)
        # = sin(acos(c)) = s, its sign flipped where IL projects
        # positively onto IJ + IK (addone: projhfg > 0 -> s = -s)
        a = torch.linalg.cross(vb1, vb2)
        ra = torch.sqrt(torch.clamp(torch.sum(a * a, -1), min=1e-24))
        rh = torch.sqrt(torch.clamp(torch.sum(vb3 * vb3, -1), min=1e-24))
        c = torch.clamp(torch.sum(a * vb3, -1) / (ra * rh),
                        -1.0 + _EPS, 1.0 - _EPS)
        s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24))
        proj = (torch.sum(vb3 * vb1, -1)
                / torch.sqrt(torch.clamp(torch.sum(vb1 * vb1, -1),
                                         min=1e-30))
                + torch.sum(vb3 * vb2, -1)
                / torch.sqrt(torch.clamp(torch.sum(vb2 * vb2, -1),
                                         min=1e-30)))
        s = torch.where(proj > 0.0, -s, s)

        def p(t):
            return self.per(t, c, ttype)
        return p(self.k) * (p(self.c0) + p(self.c1) * s
                            + p(self.c2) * (2.0 * s * s - 1.0))

    def _energy(self, xs, ttype, box):
        vb1 = minimum_image(xs[1] - xs[0], box)
        vb2 = minimum_image(xs[2] - xs[0], box)
        vb3 = minimum_image(xs[3] - xs[0], box)
        e = self._one(vb1, vb2, vb3, ttype)
        allf = self.table(self.all, vb1, torch.int32)[ttype] > 0
        e2 = self._one(vb3, vb1, vb2, ttype)
        e3 = self._one(vb2, vb3, vb1, ttype)
        return e + torch.where(allf, e2 + e3, 0.0)


@register_bonded("improper", "ring")
class ImproperRing(_EnergyImproper):
    """E = K/6 [sum_{3 triads} (cos theta_i - cos chi0)]^6, triads
    (1,2,4), (1,2,3), (4,2,3) with the cosine of consecutive bond vectors
    (src/EXTRA-MOLECULE/improper_ring.cpp:60-95)."""

    name = "ring"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = _zeros(ntypes)
        self.chi = _zeros(ntypes)  # cos(chi0)

    def coeff(self, itype, k, chi):
        self.k[itype] = k
        self.chi[itype] = np.cos(chi * DEG2RAD)

    def _energy(self, xs, ttype, box):
        x1, x2, x3, x4 = xs

        def bend(a, b, c):
            b1 = minimum_image(b - a, box)
            b2 = minimum_image(c - b, box)
            return cos_angle(b1, b2, safe_r(b1), safe_r(b2))
        summ = (bend(x1, x2, x4) + bend(x1, x2, x3) + bend(x4, x2, x3)
                - 3.0 * self.per(self.chi, x1, ttype))
        return (1.0 / 6.0) * self.per(self.k, x1, ttype) * summ ** 6


@register_bonded("improper", "distance")
class ImproperDistance(_EnergyImproper):
    """E = K2 d^2 + K4 d^4, d the distance of atom 1 from the plane of
    atoms 2-3-4 (src/EXTRA-MOLECULE/improper_distance.cpp:80-120)."""

    name = "distance"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = _zeros(ntypes)
        self.chi = _zeros(ntypes)  # K4 (named chi in the reference)

    def coeff(self, itype, k2, k4):
        self.k[itype] = k2
        self.chi[itype] = k4

    def _energy(self, xs, ttype, box):
        x1, x2, x3, x4 = xs
        ab = minimum_image(x2 - x1, box)
        bc = minimum_image(x3 - x2, box)
        bd = minimum_image(x4 - x2, box)
        n = torch.linalg.cross(bc, bd)
        n = n / torch.sqrt(torch.clamp(torch.sum(n * n, -1),
                                       min=1e-30))[:, None]
        da = torch.sum(n * ab, -1)
        return (self.per(self.k, da, ttype) * da * da
                + self.per(self.chi, da, ttype) * da ** 4)
