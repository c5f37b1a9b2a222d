"""CLASS2 (COMPASS) bonded styles: bond, angle, dihedral and improper class2
(src/CLASS2/bond_class2.cpp, angle_class2.cpp, dihedral_class2.cpp,
improper_class2.cpp), the port's copy of tpumd/models/bonded_class2.py.

Each 3- and 4-body style states its per-tuple energy as the reference
defines it, cross terms included, and takes the member forces as minus the
gradient of the summed tuple energy (``grad_terms``, torch.autograd.grad;
tpumd takes jax.grad of the same sum).  Each tuple's energy depends only on
its own members, so that gradient is the per-tuple force set.  Lengths go
through ``_safe_r`` and cosines through a clamp short of +-1, so a
zero-length vector or a straight angle gives no NaN in the reverse pass.
The run loop must not be under torch.inference_mode (nothing in the port
enters it).

Angle conventions (tpumd holds them to the reference binary's goldens):
- theta terms use acos(clamp(c)) with c = d1.d2/(r1 r2);
- the dihedral angle is signed: phi = -acos(c) when (vb1 x vb2).vb3 > 0
  (dihedral_class2.cpp:131-139), written smoothly as
  atan2(((x2-x1) x vb2).vb3 * r2, n1.n2);
- the improper's chi is the mean of three asin Wilson angles
  (improper_class2.cpp:150-165).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.models.bonded import AngleStyle, BondStyle, \
    DihedralStyle, ImproperStyle
from tpumd_torch.models.registry import register_bonded

_EPS = 1e-12
DEG2RAD = np.pi / 180.0


def safe_r(d):
    """|d| with the length floored at 1e-15 (no NaN in the gradient)."""
    return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=1e-30))


def cos_angle(d1, d2, r1, r2):
    return torch.clamp(torch.sum(d1 * d2, -1) / (r1 * r2),
                       -1.0 + _EPS, 1.0 - _EPS)


def grad_terms(efn, xs):
    """(member forces, per-tuple energy) of the energy function efn of
    the member positions: forces = -grad of the summed energy."""
    with torch.enable_grad():
        req = [x.detach().requires_grad_(True) for x in xs]
        e = efn(req)
        grads = torch.autograd.grad(torch.sum(e), req)
    return [-g for g in grads], e.detach()


class EnergyStyle:
    """A 3- or 4-body style given by its per-tuple energy ``_energy(xs,
    ttype, box)``; the virial pairs are those of ``_virial_vectors``."""

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        fs, e = grad_terms(lambda xs_: self._energy(xs_, ttype, box), xs)
        vp = None
        if vflag:
            vp = [(r, fs[k]) for r, k in self._virial_vectors(xs, box)]
        return fs, {self.energy_key: e} if eflag else None, vp

    def _virial_vectors(self, xs, box):
        """[(r, member whose force pairs with r)]: bonds 1-2 and 3-2 of
        an angle; vb1, vb2 and vb3 + vb2 of a dihedral."""
        vb1 = minimum_image(xs[0] - xs[1], box)
        vb2 = minimum_image(xs[2] - xs[1], box)
        if self.arity == 3:
            return [(vb1, 0), (vb2, 2)]
        vb3 = minimum_image(xs[3] - xs[2], box)
        return [(vb1, 0), (vb2, 2), (vb3 + vb2, 3)]


def signed_phi(vb1, vb2, vb3, r2):
    """The signed dihedral angle: the reference's acos(c) with the
    (vb1 x vb2).vb3 sign flip, smooth for the gradient through atan2."""
    n1 = torch.linalg.cross(-vb1, vb2)
    n2 = torch.linalg.cross(vb2, vb3)
    sy = torch.sum(n1 * vb3, -1) * r2
    cy = torch.sum(n1 * n2, -1)
    deg = (torch.abs(sy) + torch.abs(cy)) < 1e-20
    return torch.arctan2(torch.where(deg, 0.0, sy),
                         torch.where(deg, 1.0, cy))


@register_bonded("bond", "class2")
class BondClass2(BondStyle):
    """E = K2 dr^2 + K3 dr^3 + K4 dr^4 (src/CLASS2/bond_class2.cpp)."""

    name = "class2"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.r0 = np.zeros(ntypes + 1)
        self.k2 = np.zeros(ntypes + 1)
        self.k3 = np.zeros(ntypes + 1)
        self.k4 = np.zeros(ntypes + 1)

    def coeff(self, btype, r0, k2, k3, k4):
        self.r0[btype] = r0
        self.k2[btype] = k2
        self.k3[btype] = k3
        self.k4[btype] = k4

    def bond_fn(self, r2, btype):
        r0, k2, k3, k4 = (self.per(a, r2, btype) for a in (
            self.r0, self.k2, self.k3, self.k4))
        r = torch.sqrt(r2)
        dr = r - r0
        de = 2.0 * k2 * dr + 3.0 * k3 * dr * dr + 4.0 * k4 * dr * dr * dr
        fbond = torch.where(r > 0, -de / torch.clamp(r, min=1e-30), 0.0)
        return fbond, (k2 + (k3 + k4 * dr) * dr) * dr * dr


@register_bonded("angle", "class2")
class AngleClass2(EnergyStyle, AngleStyle):
    """Quartic angle + BondBond + BondAngle cross terms
    (src/CLASS2/angle_class2.cpp:110-215):
      E = K2 dt^2 + K3 dt^3 + K4 dt^4
        + M (r1-bb_r1)(r2-bb_r2)
        + [N1 (r1-ba_r1) + N2 (r2-ba_r2)] dt
    The cross terms come from ``angle_coeff N bb M r1 r2`` and
    ``angle_coeff N ba N1 N2 r1 r2`` or the BondBond and BondAngle Coeffs
    sections of a data file."""

    name = "class2"

    def __init__(self, ntypes):
        super().__init__(ntypes)

        def z():
            return np.zeros(ntypes + 1)
        self.theta0, self.k2, self.k3, self.k4 = z(), z(), z(), z()
        self.bb_k, self.bb_r1, self.bb_r2 = z(), z(), z()
        self.ba_k1, self.ba_k2, self.ba_r1, self.ba_r2 = z(), z(), z(), z()

    def coeff(self, atype, *a):
        if a and a[0] == "bb":
            self.bb_k[atype], self.bb_r1[atype], self.bb_r2[atype] = a[1:4]
        elif a and a[0] == "ba":
            (self.ba_k1[atype], self.ba_k2[atype],
             self.ba_r1[atype], self.ba_r2[atype]) = a[1:5]
        else:
            self.theta0[atype] = a[0] * DEG2RAD
            self.k2[atype], self.k3[atype], self.k4[atype] = a[1:4]

    def _energy(self, xs, ttype, box):
        x1, x2, x3 = xs
        d1 = minimum_image(x1 - x2, box)
        d2 = minimum_image(x3 - x2, box)
        r1, r2 = safe_r(d1), safe_r(d2)
        c = cos_angle(d1, d2, r1, r2)

        def p(t):
            return self.per(t, c, ttype)
        dt = torch.arccos(c) - p(self.theta0)
        e = (p(self.k2) + (p(self.k3) + p(self.k4) * dt) * dt) * dt * dt
        e = e + p(self.bb_k) * (r1 - p(self.bb_r1)) * (r2 - p(self.bb_r2))
        e = e + (p(self.ba_k1) * (r1 - p(self.ba_r1))
                 + p(self.ba_k2) * (r2 - p(self.ba_r2))) * dt
        return e


@register_bonded("dihedral", "class2")
class DihedralClass2(EnergyStyle, DihedralStyle):
    """Triple-cosine torsion + mbt/ebt/at/aat/bb13 cross terms
    (src/CLASS2/dihedral_class2.cpp:170-540):
      E = sum_n K_n (1 - cos(n phi - phi_n))
        + (r2 - mbt_r0)      sum_n mbt_fn   cos(n phi)
        + (r1 - ebt_r0_1)    sum_n ebt_fn_1 cos(n phi)
        + (r3 - ebt_r0_2)    sum_n ebt_fn_2 cos(n phi)
        + (th12 - at_th0_1)  sum_n at_fn_1  cos(n phi)
        + (th23 - at_th0_2)  sum_n at_fn_2  cos(n phi)
        + aat_k (th12 - aat_th1)(th23 - aat_th2) cos(phi)
        + bb13_k (r1 - r10)(r3 - r30)
    with r1=|x1-x2|, r2=|x3-x2|, r3=|x4-x3| and the signed phi."""

    name = "class2"

    def __init__(self, ntypes):
        super().__init__(ntypes)

        def z():
            return np.zeros(ntypes + 1)
        self.k1, self.k2, self.k3 = z(), z(), z()
        self.phi1, self.phi2, self.phi3 = z(), z(), z()
        self.mbt_f1, self.mbt_f2, self.mbt_f3, self.mbt_r0 = (z(), z(),
                                                              z(), z())
        (self.ebt_f1_1, self.ebt_f2_1, self.ebt_f3_1, self.ebt_f1_2,
         self.ebt_f2_2, self.ebt_f3_2, self.ebt_r0_1,
         self.ebt_r0_2) = (z() for _ in range(8))
        (self.at_f1_1, self.at_f2_1, self.at_f3_1, self.at_f1_2,
         self.at_f2_2, self.at_f3_2, self.at_theta0_1,
         self.at_theta0_2) = (z() for _ in range(8))
        self.aat_k, self.aat_theta0_1, self.aat_theta0_2 = z(), z(), z()
        self.bb13t_k, self.bb13t_r10, self.bb13t_r30 = z(), z(), z()

    def coeff(self, dt, *a):
        if a and a[0] == "mbt":
            (self.mbt_f1[dt], self.mbt_f2[dt], self.mbt_f3[dt],
             self.mbt_r0[dt]) = a[1:5]
        elif a and a[0] == "ebt":
            (self.ebt_f1_1[dt], self.ebt_f2_1[dt], self.ebt_f3_1[dt],
             self.ebt_f1_2[dt], self.ebt_f2_2[dt], self.ebt_f3_2[dt],
             self.ebt_r0_1[dt], self.ebt_r0_2[dt]) = a[1:9]
        elif a and a[0] == "at":
            (self.at_f1_1[dt], self.at_f2_1[dt], self.at_f3_1[dt],
             self.at_f1_2[dt], self.at_f2_2[dt],
             self.at_f3_2[dt]) = a[1:7]
            self.at_theta0_1[dt] = a[7] * DEG2RAD
            self.at_theta0_2[dt] = a[8] * DEG2RAD
        elif a and a[0] == "aat":
            self.aat_k[dt] = a[1]
            self.aat_theta0_1[dt] = a[2] * DEG2RAD
            self.aat_theta0_2[dt] = a[3] * DEG2RAD
        elif a and a[0] == "bb13":
            (self.bb13t_k[dt], self.bb13t_r10[dt],
             self.bb13t_r30[dt]) = a[1:4]
        else:
            self.k1[dt], self.k2[dt], self.k3[dt] = a[0], a[2], a[4]
            self.phi1[dt] = a[1] * DEG2RAD
            self.phi2[dt] = a[3] * DEG2RAD
            self.phi3[dt] = a[5] * DEG2RAD

    def _energy(self, xs, ttype, box):
        x1, x2, x3, x4 = xs
        vb1 = minimum_image(x1 - x2, box)
        vb2 = minimum_image(x3 - x2, box)
        vb3 = minimum_image(x4 - x3, box)
        r1, r2, r3 = safe_r(vb1), safe_r(vb2), safe_r(vb3)
        th12 = torch.arccos(cos_angle(vb1, vb2, r1, r2))
        th23 = torch.arccos(cos_angle(-vb2, vb3, r2, r3))
        phi = signed_phi(vb1, vb2, vb3, r2)
        c1, c2, c3 = torch.cos(phi), torch.cos(2 * phi), torch.cos(3 * phi)

        def p(t):
            return self.per(t, r1, ttype)
        e = (p(self.k1) * (1.0 - torch.cos(phi - p(self.phi1)))
             + p(self.k2) * (1.0 - torch.cos(2.0 * phi - p(self.phi2)))
             + p(self.k3) * (1.0 - torch.cos(3.0 * phi - p(self.phi3))))
        e = e + (r2 - p(self.mbt_r0)) * (p(self.mbt_f1) * c1
                                         + p(self.mbt_f2) * c2
                                         + p(self.mbt_f3) * c3)
        e = e + (r1 - p(self.ebt_r0_1)) * (p(self.ebt_f1_1) * c1
                                           + p(self.ebt_f2_1) * c2
                                           + p(self.ebt_f3_1) * c3)
        e = e + (r3 - p(self.ebt_r0_2)) * (p(self.ebt_f1_2) * c1
                                           + p(self.ebt_f2_2) * c2
                                           + p(self.ebt_f3_2) * c3)
        e = e + (th12 - p(self.at_theta0_1)) * (p(self.at_f1_1) * c1
                                                + p(self.at_f2_1) * c2
                                                + p(self.at_f3_1) * c3)
        e = e + (th23 - p(self.at_theta0_2)) * (p(self.at_f1_2) * c1
                                                + p(self.at_f2_2) * c2
                                                + p(self.at_f3_2) * c3)
        e = e + (p(self.aat_k) * (th12 - p(self.aat_theta0_1))
                 * (th23 - p(self.aat_theta0_2)) * c1)
        e = e + (p(self.bb13t_k) * (r1 - p(self.bb13t_r10))
                 * (r3 - p(self.bb13t_r30)))
        return e


@register_bonded("improper", "class2")
class ImproperClass2(EnergyStyle, ImproperStyle):
    """Wilson out-of-plane chi average + AngleAngle cross term
    (src/CLASS2/improper_class2.cpp:100-210 and angleangle :360-460):
      E = K (chi_bar - chi0)^2,
        chi_bar = [asin(s_ABCD) + asin(s_CBDA) + asin(s_DBAC)] / 3
      E_aa = M2 dthABC dthABD + M1 dthABC dthCBD + M3 dthABD dthCBD
    with AB = x1-x2, CB = x3-x2, DB = x4-x2 (atom 2 is the center)."""

    name = "class2"

    def __init__(self, ntypes):
        super().__init__(ntypes)

        def z():
            return np.zeros(ntypes + 1)
        self.k0, self.chi0 = z(), z()
        self.aa_k1, self.aa_k2, self.aa_k3 = z(), z(), z()
        self.aa_theta0_1, self.aa_theta0_2, self.aa_theta0_3 = z(), z(), z()

    def coeff(self, itype, *a):
        if a and a[0] == "aa":
            self.aa_k1[itype], self.aa_k2[itype], self.aa_k3[itype] = a[1:4]
            self.aa_theta0_1[itype] = a[4] * DEG2RAD
            self.aa_theta0_2[itype] = a[5] * DEG2RAD
            self.aa_theta0_3[itype] = a[6] * DEG2RAD
        else:
            self.k0[itype] = a[0]
            self.chi0[itype] = a[1] * DEG2RAD

    def _energy(self, xs, ttype, box):
        x1, x2, x3, x4 = xs
        ab = minimum_image(x1 - x2, box)
        cb = minimum_image(x3 - x2, box)
        db = minimum_image(x4 - x2, box)
        rab, rcb, rdb = safe_r(ab), safe_r(cb), safe_r(db)

        def p(t):
            return self.per(t, rab, ttype)
        # each chi normalises by the sine of the opposite angle
        # (improper_class2.cpp:150-160)
        s0 = torch.sqrt(torch.clamp(
            1.0 - cos_angle(ab, cb, rab, rcb) ** 2, min=1e-16))
        s1 = torch.sqrt(torch.clamp(
            1.0 - cos_angle(cb, db, rcb, rdb) ** 2, min=1e-16))
        s2 = torch.sqrt(torch.clamp(
            1.0 - cos_angle(ab, db, rab, rdb) ** 2, min=1e-16))
        inv3r = 1.0 / (rab * rcb * rdb)

        def asin_c(v):
            return torch.arcsin(torch.clamp(v, -1.0 + _EPS, 1.0 - _EPS))
        cross = torch.linalg.cross
        chi_abcd = asin_c(torch.sum(cross(cb, db) * ab, -1) * inv3r / s1)
        chi_cbda = asin_c(torch.sum(cross(db, ab) * cb, -1) * inv3r / s2)
        chi_dbac = asin_c(torch.sum(cross(ab, cb) * db, -1) * inv3r / s0)
        dchi = (chi_abcd + chi_cbda + chi_dbac) / 3.0 - p(self.chi0)
        k0 = p(self.k0)
        e = torch.where(k0 != 0.0, k0 * dchi * dchi, 0.0)
        # the angle-angle term (angleangle(): BC == CB, BD == DB)
        th_abc = torch.arccos(cos_angle(ab, cb, rab, rcb))
        th_abd = torch.arccos(cos_angle(ab, db, rab, rdb))
        th_cbd = torch.arccos(cos_angle(cb, db, rcb, rdb))
        d1 = th_abc - p(self.aa_theta0_1)
        d2 = th_abd - p(self.aa_theta0_2)
        d3 = th_cbd - p(self.aa_theta0_3)
        return e + (p(self.aa_k2) * d1 * d2 + p(self.aa_k1) * d1 * d3
                    + p(self.aa_k3) * d2 * d3)

    def _virial_vectors(self, xs, box):
        """AB, CB and DB with the forces on members 1, 3 and 4."""
        return [(minimum_image(xs[k] - xs[1], box), k) for k in (0, 2, 3)]
