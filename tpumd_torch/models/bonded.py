"""Bonded styles: bonds, angles, dihedrals and impropers.

PyTorch counterpart of tpumd/models/bonded.py (the reference's NTopo
tuple loops: src/MOLECULE/bond_harmonic.cpp, bond_fene.cpp,
angle_charmm.cpp, dihedral_charmm.cpp, improper_harmonic.cpp).  Two paths:

- FENE rides the cell-grid pair kernel: each candidate's tag is matched
  against the i slot's bond-partner tags (``kernel_bond``), so the style
  is a coefficient table plus the per-pair force and energy.
- Every other style is evaluated once per tuple on the tag-order view of
  the grid-permuted atoms: the members' positions are gathered through
  ``row2slot``, each tuple's member forces are added into their atoms with
  ``index_add_``, and the energy and virial are plain sums over tuples.
  ``compute_tuples`` is that driver.  (tpumd evaluates each tuple once per
  member atom to avoid scatters on the TPU, with 1/arity tallies; the sums
  are the same.)
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.models.registry import register_bonded
from tpumd_torch.ops.lj_fene_cellgrid import FENECoeffs, fene_wca


class BondedStyle:
    kind = "bond"
    arity = 2
    energy_key = "ebond"
    name = "none"
    kernel_bond = False     # evaluated inside the pair kernel (FENE)

    def __init__(self, ntypes: int):
        self.ntypes = ntypes
        self._tables = {}

    def coeff(self, *args):
        raise NotImplementedError

    def init(self):
        """Called at set-up: coefficients may have changed."""
        self._tables = {}

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        """Per tuple: (member forces [arity x (M, 3)], {key: (M,)} energies
        or None, [(r, f)] virial pairs or None); extra pair-energy terms
        ride the energies dict under their own keys."""
        raise NotImplementedError

    def table(self, arr, like, dtype=None):
        """A coefficient table on like's device, in like's dtype (or
        dtype), made once per set-up: a host copy every step would wait
        for the card."""
        dtype = like.dtype if dtype is None else dtype
        key = (id(arr), dtype, like.device)
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = torch.as_tensor(arr, dtype=dtype,
                                                    device=like.device)
        return t


def voigt(w):
    """(xx yy zz xy xz yz) of a 3x3 tensor."""
    return torch.stack([w[0, 0], w[1, 1], w[2, 2], w[0, 1], w[0, 2],
                        w[1, 2]])


def _virial6(pairs):
    """sum over (r, f) pairs of r_a f_b for (xx yy zz xy xz yz), as one
    contraction."""
    r = torch.stack([p[0] for p in pairs])
    f = torch.stack([p[1] for p in pairs])
    return voigt(torch.einsum("pmi,pmj->ij", r, f))


def compute_tuples(style, view, tuples, box, ctx, eflag: bool, vflag: bool):
    """One bonded style over its tuples on the tag-order view.

    view = (x, type, q) per tag (row tag-1); tuples (M, 1 + arity) int64 on
    the device: the tuple type, then the members as tag-1.  Returns
    (f (natoms, 3) per tag, {key: energy} or None, virial (6,) or None)."""
    x = view[0]
    f = torch.zeros_like(x)
    if tuples.shape[0] == 0:
        zero = x.new_zeros(())
        return (f, {style.energy_key: zero} if eflag else None,
                x.new_zeros(6) if vflag else None)
    idx = [tuples[:, 1 + k] for k in range(style.arity)]
    xs = [torch.index_select(x, 0, i) for i in idx]
    flist, ed, vp = style.tuple_terms(xs, tuples[:, 0], box, (view, idx),
                                      ctx, eflag, vflag)
    for i, fm in zip(idx, flist):
        f.index_add_(0, i, fm)
    energies = ({k: torch.sum(v) for k, v in ed.items()} if eflag
                else None)
    return f, energies, (_virial6(vp) if vflag else None)


# ---------------------------------------------------------------- bonds
class BondStyle(BondedStyle):
    arity = 2
    kind = "bond"
    energy_key = "ebond"

    def bond_fn(self, r2, btype):
        """(fbond, ebond) per bond: f_on_atom1 = fbond * (x1 - x2)."""
        raise NotImplementedError

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        d = minimum_image(xs[0] - xs[1], box)
        r2 = torch.sum(d * d, dim=-1)
        fbond, ebond = self.bond_fn(r2, ttype)
        f1 = fbond[:, None] * d
        return ([f1, -f1], {self.energy_key: ebond} if eflag else None,
                [(d, f1)] if vflag else None)


@register_bonded("bond", "harmonic")
class BondHarmonic(BondStyle):
    """E = K (r - r0)^2 (src/MOLECULE/bond_harmonic.cpp)."""

    name = "harmonic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.r0 = np.zeros(ntypes + 1)

    def coeff(self, btype, k, r0):
        self.k[btype] = k
        self.r0[btype] = r0

    def bond_fn(self, r2, btype):
        k = self.table(self.k, r2)[btype]
        r0 = self.table(self.r0, r2)[btype]
        r = torch.sqrt(r2)
        dr = r - r0
        rk = k * dr
        fbond = torch.where(r > 0, -2.0 * rk / r, 0.0)
        return fbond, rk * dr


@register_bonded("bond", "fene")
class BondFENE(BondStyle):
    """FENE + shifted-LJ repulsion:
    E = -0.5 K R0^2 ln(1-(r/R0)^2) + [4 eps((s/r)^12-(s/r)^6) + eps],
    the LJ part active below 2^(1/6) sigma.  The reference clamps
    1-(r/R0)^2 at 0.1 after a "FENE bond too long" warning; so do both
    packages.  The port runs FENE inside the LJ+FENE pair kernel only."""

    name = "fene"
    kernel_bond = True

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.r0 = np.zeros(ntypes + 1)
        self.epsilon = np.zeros(ntypes + 1)
        self.sigma = np.zeros(ntypes + 1)

    def coeff(self, btype, k, r0, epsilon, sigma):
        self.k[btype] = k
        self.r0[btype] = r0
        self.epsilon[btype] = epsilon
        self.sigma[btype] = sigma

    def bond_fn(self, r2, btype):
        """Coefficients read from the per-type tables."""
        def tbl(a):
            return self.table(a, r2)[btype.long()]
        sig = tbl(self.sigma)
        r0 = tbl(self.r0)
        return fene_wca(r2, tbl(self.k), r0 * r0, tbl(self.epsilon),
                        sig * sig)

    @property
    def kernel_reach(self) -> float:
        """FENE bonds cannot stretch past R0 (the log diverges): when the
        largest R0 is within cutneigh, every partner is inside the
        27-cell stencil and the bond can ride the grid kernel."""
        return float(np.max(self.r0[1:])) if len(self.r0) > 1 else 0.0

    def kernel_bond_fn(self, r2, btype):
        """bond_fn with coefficients selected per type (the form of
        tpumd's BondFENE.kernel_bond_fn)."""
        def sel(table):
            if self.ntypes == 1:
                return float(table[1])
            out = torch.zeros((), dtype=r2.dtype, device=r2.device)
            for t in range(1, self.ntypes + 1):
                out = out + (btype == t).to(r2.dtype) * float(table[t])
            return out
        k, r0 = sel(self.k), sel(self.r0)
        eps, sig = sel(self.epsilon), sel(self.sigma)
        return fene_wca(r2, k, r0 * r0, eps, sig * sig)

    def kernel_coeffs(self) -> FENECoeffs:
        """Scalar coefficients of the single-bond-type kernel."""
        if self.ntypes != 1:
            raise NotImplementedError(
                "bond_style fene with more than one bond type: the "
                "LJ+FENE cell-grid kernel takes one")
        return FENECoeffs(float(self.k[1]), float(self.r0[1]) ** 2,
                          float(self.epsilon[1]), float(self.sigma[1]) ** 2)


# --------------------------------------------------------------- angles
@register_bonded("angle", "harmonic")
class AngleHarmonic(BondedStyle):
    """E = K (theta - theta0)^2 (src/angle_harmonic.cpp)."""

    kind = "angle"
    arity = 3
    energy_key = "eangle"
    name = "harmonic"
    k_ub = None

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.theta0 = np.zeros(ntypes + 1)  # radians

    def coeff(self, atype, k, theta0_deg):
        self.k[atype] = k
        self.theta0[atype] = theta0_deg * np.pi / 180.0

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        x1, x2, x3 = xs
        d1 = minimum_image(x1 - x2, box)
        d2 = minimum_image(x3 - x2, box)
        rsq1 = torch.sum(d1 * d1, -1)
        rsq2 = torch.sum(d2 * d2, -1)
        r1 = torch.sqrt(torch.clamp(rsq1, min=1e-30))
        r2 = torch.sqrt(torch.clamp(rsq2, min=1e-30))
        k = self.table(self.k, r1)[ttype]
        th0 = self.table(self.theta0, r1)[ttype]
        c = torch.clamp(torch.sum(d1 * d2, -1) / (r1 * r2), -1.0, 1.0)
        sinv = 1.0 / torch.clamp(torch.sqrt(1.0 - c * c), min=0.001)
        dtheta = torch.arccos(c) - th0
        tk = k * dtheta
        e = tk * dtheta
        a = -2.0 * tk * sinv
        a11 = a * c / rsq1
        a12 = -a / (r1 * r2)
        a22 = a * c / rsq2
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        if self.k_ub is not None:
            # Urey-Bradley 1-3 spring (angle charmm)
            dub = minimum_image(x3 - x1, box)
            rub = torch.sqrt(torch.clamp(torch.sum(dub * dub, -1),
                                         min=1e-30))
            drub = rub - self.table(self.r_ub, rub)[ttype]
            rkub = self.table(self.k_ub, rub)[ttype] * drub
            force_ub = -2.0 * rkub / rub
            e = e + rkub * drub
            f1 = f1 - dub * force_ub[:, None]
            f3 = f3 + dub * force_ub[:, None]
        f2 = -(f1 + f3)
        return ([f1, f2, f3], {self.energy_key: e} if eflag else None,
                [(d1, f1), (d2, f3)] if vflag else None)


@register_bonded("angle", "charmm")
class AngleCharmm(AngleHarmonic):
    """CHARMM angle: harmonic + Urey-Bradley 1-3 spring
    (src/MOLECULE/angle_charmm.cpp)."""

    name = "charmm"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k_ub = np.zeros(ntypes + 1)
        self.r_ub = np.zeros(ntypes + 1)

    def coeff(self, atype, k, theta0_deg, k_ub=0.0, r_ub=0.0):
        super().coeff(atype, k, theta0_deg)
        self.k_ub[atype] = k_ub
        self.r_ub[atype] = r_ub


# ------------------------------------------------------------ dihedrals
def _dihedral_geometry(xs, box):
    """Shared CHARMM/harmonic dihedral geometry (dihedral_charmm.cpp)."""
    x1, x2, x3, x4 = xs
    vb1 = minimum_image(x1 - x2, box)
    vb2 = minimum_image(x3 - x2, box)
    vb2m = -vb2
    vb3 = minimum_image(x4 - x3, box)
    a = torch.linalg.cross(vb1, vb2m)
    b = torch.linalg.cross(vb3, vb2m)
    rasq = torch.sum(a * a, -1)
    rbsq = torch.sum(b * b, -1)
    rg = torch.sqrt(torch.sum(vb2m * vb2m, -1))
    rginv = torch.where(rg > 0, 1.0 / torch.clamp(rg, min=1e-30), 0.0)
    ra2inv = torch.where(rasq > 0, 1.0 / torch.clamp(rasq, min=1e-30), 0.0)
    rb2inv = torch.where(rbsq > 0, 1.0 / torch.clamp(rbsq, min=1e-30), 0.0)
    rabinv = torch.sqrt(ra2inv * rb2inv)
    c = torch.clamp(torch.sum(a * b, -1) * rabinv, -1.0, 1.0)
    s = rg * rabinv * torch.sum(a * vb3, -1)
    return vb1, vb2, vb2m, vb3, a, b, rg, rginv, ra2inv, rb2inv, c, s


def _dihedral_forces(vb1, vb2m, vb3, a, b, rg, rginv, ra2inv, rb2inv, df):
    fg = torch.sum(vb1 * vb2m, -1)
    hg = torch.sum(vb3 * vb2m, -1)
    fga = fg * ra2inv * rginv
    hgb = hg * rb2inv * rginv
    gaa = -ra2inv * rg
    gbb = rb2inv * rg
    dtf = gaa[:, None] * a
    dtg = fga[:, None] * a - hgb[:, None] * b
    dth = gbb[:, None] * b
    f1 = df[:, None] * dtf
    s2 = df[:, None] * dtg
    f2 = s2 - f1
    f4 = df[:, None] * dth
    f3 = -s2 - f4
    return f1, f2, f3, f4


@register_bonded("dihedral", "harmonic")
class DihedralHarmonic(BondedStyle):
    """E = K[1 + d cos(n phi)] (src/dihedral_harmonic.cpp)."""

    kind = "dihedral"
    arity = 4
    energy_key = "edihed"
    name = "harmonic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.sign = np.zeros(ntypes + 1)
        self.mult = np.zeros(ntypes + 1, dtype=np.int32)

    def coeff(self, dtype_, k, d, n):
        self.k[dtype_] = k
        self.sign[dtype_] = d
        self.mult[dtype_] = int(n)

    def init(self):
        super().init()
        self._cos_sh, self._sin_sh = self._phase()

    def _phase(self):
        """(cos, sin) of each type's phase: d = +-1 is a phase of 0 or
        pi."""
        return np.where(self.sign >= 0, 1.0, -1.0), np.zeros(len(self.sign))

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        (vb1, vb2, vb2m, vb3, a, b, rg, rginv,
         ra2inv, rb2inv, c, sv) = _dihedral_geometry(xs, box)
        kk = self.table(self.k, c)[ttype]
        cos_sh = self.table(self._cos_sh, c)[ttype]
        sin_sh = self.table(self._sin_sh, c)[ttype]
        mult = self.table(self.mult, c, torch.int32)[ttype]
        # p = cos(n phi), df1 = sin(n phi) by the reference's recurrence
        p = torch.ones_like(c)
        df1 = torch.zeros_like(c)
        ddf1 = torch.zeros_like(c)
        for i in range(int(self.mult.max()) if self.mult.size else 0):
            do = i < mult
            ddf1_n = p * c - df1 * sv
            df1_n = p * sv + df1 * c
            ddf1 = torch.where(do, ddf1_n, ddf1)
            df1 = torch.where(do, df1_n, df1)
            p = torch.where(do, ddf1_n, p)
        p_out = p * cos_sh + df1 * sin_sh + 1.0
        df_out = (df1 * cos_sh - ddf1 * sin_sh) * (-mult)
        zero_m = mult == 0
        p_out = torch.where(zero_m, 1.0 + cos_sh, p_out)
        df_out = torch.where(zero_m, 0.0, df_out)
        f1, f2, f3, f4 = _dihedral_forces(vb1, vb2m, vb3, a, b, rg, rginv,
                                          ra2inv, rb2inv, -kk * df_out)
        return ([f1, f2, f3, f4],
                {self.energy_key: kk * p_out} if eflag else None,
                [(vb1, f1), (vb2, f3), (vb3 + vb2, f4)] if vflag else None)


@register_bonded("dihedral", "charmm")
class DihedralCharmm(DihedralHarmonic):
    """CHARMM dihedral: K[1+cos(n phi - d)] + weighted 1-4 LJ/Coulomb
    (src/MOLECULE/dihedral_charmm.cpp).  The 1-4 pair reads the pair
    style's lj14 tables, and its energies are tallied as pair energies
    (evdwl, ecoul), as the reference does."""

    name = "charmm"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.weight = np.zeros(ntypes + 1)
        self.shift_deg = np.zeros(ntypes + 1)

    def coeff(self, dtype_, k, n, d_deg, weight):
        self.k[dtype_] = k
        self.mult[dtype_] = int(n)
        self.shift_deg[dtype_] = d_deg
        self.weight[dtype_] = weight

    def _phase(self):
        rad = self.shift_deg * np.pi / 180.0
        return np.cos(rad), np.sin(rad)

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        flist, ed, vp = super().tuple_terms(xs, ttype, box, view, ctx,
                                            eflag, vflag)
        # the weighted 1-4 pair between members 1 and 4
        (_, types, q), idx = view
        w = self.table(self.weight, xs[0])[ttype]
        pair = ctx.pair
        it = torch.index_select(types, 0, idx[0]).long()
        jt = torch.index_select(types, 0, idx[3]).long()
        q1 = torch.index_select(q, 0, idx[0])
        q4 = torch.index_select(q, 0, idx[3])
        d14 = minimum_image(xs[0] - xs[3], box)
        r2inv = 1.0 / torch.clamp(torch.sum(d14 * d14, -1), min=1e-30)
        r6inv = r2inv * r2inv * r2inv
        ecoul = ctx.units.qqr2e * q1 * q4 * torch.sqrt(r2inv)
        forcelj = r6inv * (self.table(pair.lj14_1, w)[it, jt] * r6inv
                           - self.table(pair.lj14_2, w)[it, jt])
        act = w > 0
        fpair = torch.where(act, w * (forcelj + ecoul) * r2inv, 0.0)
        f14 = fpair[:, None] * d14
        flist = [flist[0] + f14, flist[1], flist[2], flist[3] - f14]
        if eflag:
            ed["ecoul"] = torch.where(act, w * ecoul, 0.0)
            ed["evdwl"] = torch.where(act, w * r6inv * (
                self.table(pair.lj14_3, w)[it, jt] * r6inv
                - self.table(pair.lj14_4, w)[it, jt]), 0.0)
        if vflag:
            vp = vp + [(d14, f14)]
        return flist, ed, vp


# ------------------------------------------------------------ impropers
@register_bonded("improper", "harmonic")
class ImproperHarmonic(BondedStyle):
    """E = K (chi - chi0)^2 (src/MOLECULE/improper_harmonic.cpp)."""

    kind = "improper"
    arity = 4
    energy_key = "eimp"
    name = "harmonic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.chi = np.zeros(ntypes + 1)

    def coeff(self, itype, k, chi_deg):
        self.k[itype] = k
        self.chi[itype] = chi_deg * np.pi / 180.0

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        x1, x2, x3, x4 = xs
        vb1 = minimum_image(x1 - x2, box)
        vb2 = minimum_image(x3 - x2, box)
        vb3 = minimum_image(x4 - x3, box)
        ss1 = 1.0 / torch.clamp(torch.sum(vb1 * vb1, -1), min=1e-30)
        ss2 = 1.0 / torch.clamp(torch.sum(vb2 * vb2, -1), min=1e-30)
        ss3 = 1.0 / torch.clamp(torch.sum(vb3 * vb3, -1), min=1e-30)
        r1, r2, r3 = torch.sqrt(ss1), torch.sqrt(ss2), torch.sqrt(ss3)
        c0 = torch.sum(vb1 * vb3, -1) * r1 * r3
        c1 = torch.sum(vb1 * vb2, -1) * r1 * r2
        c2 = -torch.sum(vb3 * vb2, -1) * r3 * r2
        s1 = 1.0 / torch.clamp(1.0 - c1 * c1, min=0.001)
        s2 = 1.0 / torch.clamp(1.0 - c2 * c2, min=0.001)
        s12 = torch.sqrt(s1 * s2)
        c = torch.clamp((c1 * c2 + c0) * s12, -1.0, 1.0)
        sth = torch.clamp(torch.sqrt(1.0 - c * c), min=0.001)
        kk = self.table(self.k, c)[ttype]
        domega = torch.arccos(c) - self.table(self.chi, c)[ttype]
        aa = kk * domega
        e = aa * domega
        aa = -aa * 2.0 / sth
        cc = c * aa
        s12a = s12 * aa
        a11 = cc * ss1 * s1
        a22 = -ss2 * (2.0 * c0 * s12a - cc * (s1 + s2))
        a33 = cc * ss3 * s2
        a12 = -r1 * r2 * (c1 * cc * s1 + c2 * s12a)
        a13 = -r1 * r3 * s12a
        a23 = r2 * r3 * (c2 * cc * s2 + c1 * s12a)
        sx2 = (a22[:, None] * vb2 + a23[:, None] * vb3
               + a12[:, None] * vb1)
        f1 = (a12[:, None] * vb2 + a13[:, None] * vb3
              + a11[:, None] * vb1)
        f2 = -sx2 - f1
        f4 = (a23[:, None] * vb2 + a33[:, None] * vb3
              + a13[:, None] * vb1)
        f3 = sx2 - f4
        return ([f1, f2, f3, f4], {self.energy_key: e} if eflag else None,
                [(vb1, f1), (vb2, f3), (vb3 + vb2, f4)] if vflag else None)

