"""Bonded styles: bonds, angles, dihedrals and impropers.

PyTorch counterpart of tpumd/models/bonded.py (the reference's NTopo
tuple loops: src/MOLECULE/bond_harmonic.cpp, bond_fene.cpp,
angle_charmm.cpp, dihedral_charmm.cpp, improper_harmonic.cpp and the
other styles of src/MOLECULE and src/EXTRA-MOLECULE named below; the
class2, EXTRA-MOLECULE and table families live in bonded_class2.py,
bonded_extra.py and bonded_table.py).  Two paths:

- FENE rides the cell-grid pair kernel where that kernel takes it: each
  candidate's tag is matched against the i slot's bond-partner tags
  (``kernel_bond``), so the style is a coefficient table plus the
  per-pair force and energy.  Elsewhere (the matrix engine) it is a
  per-tuple style like the others.
- Every other style is evaluated once per tuple on the tag-order view of
  the engine's rows: the members' positions are gathered by tag, each
  tuple's member forces are added into their atoms with ``index_add_``,
  and the energy and virial are plain sums over tuples.
  ``compute_tuples`` is that driver; its ``take`` is the row gather (P1's
  wrapper on the matrix engine).  (tpumd evaluates each tuple once per
  member atom to avoid scatters on the TPU, with 1/arity tallies; the sums
  are the same.)

A ``hybrid`` style splits its tuples among its sub-styles by type once per
set-up (``parts``), so each sub-style sees only its own tuples; tpumd
evaluates every sub-style on every tuple under a mask.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.models.registry import register_bonded
from tpumd_torch.ops.cellgrid import row2slot_from_tags
from tpumd_torch.ops.gather import gather_rows
from tpumd_torch.ops.lj_fene_cellgrid import FENECoeffs, fene_wca


class BondedStyle:
    kind = "bond"
    arity = 2
    energy_key = "ebond"
    name = "none"
    kernel_bond = False     # evaluated inside the pair kernel (FENE)
    breakable = False       # carries a per-tuple alive mask (quartic)
    reads_types = False     # reads the members' types and charges

    def __init__(self, ntypes: int):
        self.ntypes = ntypes
        self._tables = {}

    def coeff(self, *args):
        raise NotImplementedError

    def init(self):
        """Called at set-up: coefficients may have changed."""
        self._tables = {}

    def parts(self, tuples):
        """[(style, tuples)] that evaluate this style's host tuples: the
        style itself; a hybrid's sub-styles with their own tuples."""
        return [(self, tuples)]

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        """Per tuple: (member forces [arity x (M, 3)], {key: (M,)} energies
        or None, [(r, f)] virial pairs or None); extra pair-energy terms
        ride the energies dict under their own keys.  view = ((x, type,
        q) per tag, member indices, take)."""
        raise NotImplementedError

    def table(self, arr, like, dtype=None):
        """A coefficient table on like's device, in like's dtype (or
        dtype), made once per set-up: a host copy every step would wait
        for the card.  The cache is keyed by the array's identity, so arr
        must be one the style keeps (an attribute), never a temporary."""
        dtype = like.dtype if dtype is None else dtype
        key = (id(arr), dtype, like.device)
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = torch.as_tensor(arr, dtype=dtype,
                                                    device=like.device)
        return t

    def per(self, arr, like, ttype):
        """The coefficient table arr at each tuple's type."""
        return self.table(arr, like)[ttype]

    def zero_terms(self, xs, eflag, vflag):
        """The terms of a topology-only style: no force, no energy."""
        z = torch.zeros_like(xs[0])
        return ([z] * self.arity,
                {self.energy_key: torch.zeros_like(z[:, 0])} if eflag
                else None, [(xs[0], z)] if vflag else None)

    def dihedral_terms(self, fs, vb1, vb2, vb3, e, eflag, vflag):
        """The terms of a dihedral-like style from its member forces: the
        virial pairs on the bond vectors vb1, vb2 and vb3 + vb2 with the
        forces on members 1, 3 and 4."""
        return (fs, {self.energy_key: e} if eflag else None,
                [(vb1, fs[0]), (vb2, fs[2]), (vb3 + vb2, fs[3])] if vflag
                else None)


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


def take_rows(table, idx):
    """Rows of table at idx: the grid's gather."""
    return torch.index_select(table, 0, idx)


def member_column(take, col, idx):
    """A per-tag column (type or charge) at the members idx."""
    return take(col.view(-1, 1), idx).view(-1)


def tag_view(s, ctx, row2slot=None):
    """(rows, view, take) of the bonded styles on the engine's rows:
    rows[tag - 1] is that atom's row, view = (x, type, q) in tag order,
    take the row gather of the members.  The grid's row2slot comes with
    its state and its gathers are index_select; the matrix engine's rows
    follow from the tags (ops/cellgrid.py::row2slot_from_tags) and every
    gather goes through P1 (gather_rows); types and charges are gathered
    only for a style that reads them."""
    if row2slot is not None:
        return row2slot, (take_rows(s.x, row2slot),
                          take_rows(s.type, row2slot),
                          None if s.q is None else take_rows(s.q, row2slot)
                          ), take_rows
    rows = row2slot_from_tags(s.tag, ctx.natoms).to(torch.int32)
    typed = any(st.reads_types for st, _ in ctx.bonded)

    def column(c):
        return None if c is None or not typed else member_column(
            gather_rows, c, rows)
    return rows, (gather_rows(s.x, rows), column(s.type),
                  column(s.q)), gather_rows


def members(style, view, tuples, take):
    """(member indices, member positions) of tuples on the view."""
    idx = [tuples[:, 1 + k].contiguous() for k in range(style.arity)]
    return idx, [take(view[0], i) for i in idx]


def compute_tuples(style, view, tuples, box, ctx, eflag: bool, vflag: bool,
                   take=take_rows):
    """One bonded style over its tuples on the tag-order view.

    view = (x, type, q) per tag (row tag-1); tuples (M, 1 + arity) int64
    (int32 on the matrix engine) on the device: the tuple type, then the
    members as tag-1; take(table, idx) gathers rows.  Returns (f (natoms,
    3) per tag, {key: energy} or None, virial (6,) or None)."""
    x = view[0]
    f = torch.zeros_like(x)
    if tuples.shape[0] == 0:
        zero = x.new_zeros(())
        return (f, {style.energy_key: zero} if eflag else None,
                x.new_zeros(6) if vflag else None)
    idx, xs = members(style, view, tuples, take)
    flist, ed, vp = style.tuple_terms(xs, tuples[:, 0], box,
                                      (view, idx, take), ctx, eflag, vflag)
    for i, fm in zip(idx, flist):
        f.index_add_(0, i, fm)
    energies = ({k: torch.sum(v) for k, v in ed.items()} if eflag
                else None)
    return f, energies, (_virial6(vp) if vflag else None)


def compute_tuples_peratom(style, view, tuples, box, ctx, take=take_rows):
    """Per-atom tallies of one bonded style (the "atom" branches of
    tpumd/models/bonded.py:152, :377, :1641): (eatom (natoms,), vatom
    (natoms, 6)) per tag - 1, each tuple's energy and virial split evenly
    among its members (the reference's ev_tally, ev_tally3 and ev_tally4
    shares)."""
    x = view[0]
    n = x.shape[0]
    eatom = x.new_zeros(n)
    vatom = x.new_zeros((n, 6))
    if tuples.shape[0] == 0:
        return eatom, vatom
    idx, xs = members(style, view, tuples, take)
    _, ed, vp = style.tuple_terms(xs, tuples[:, 0], box, (view, idx, take),
                                  ctx, True, True)
    inv = 1.0 / style.arity
    etup = sum(ed.values())
    r = torch.stack([p[0] for p in vp])
    fv = torch.stack([p[1] for p in vp])
    vtup = torch.stack([torch.sum(r[..., a] * fv[..., b], dim=0)
                        for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                                     (1, 2))], dim=1)
    for i in idx:
        eatom.index_add_(0, i, inv * etup)
        vatom.index_add_(0, i, inv * vtup)
    return eatom, vatom


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


class AngleStyle(BondedStyle):
    kind = "angle"
    arity = 3
    energy_key = "eangle"

    def angle_terms(self, geo, a, e, eflag, vflag):
        """The terms of an angle style of energy e whose force prefactor
        is a (angle_harmonic.cpp's a11, a12, a22 from a) on
        angle_geometry's geo."""
        d1, d2, rsq1, rsq2, r1, r2, c = geo
        a11 = a * c / rsq1
        a12 = -a / (r1 * r2)
        a22 = a * c / rsq2
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        f2 = -(f1 + f3)
        return ([f1, f2, f3], {self.energy_key: e} if eflag else None,
                [(d1, f1), (d2, f3)] if vflag else None)


def angle_geometry(xs, box):
    """(d1, d2, rsq1, rsq2, r1, r2, c) of angles 1-2-3
    (angle_harmonic.cpp)."""
    x1, x2, x3 = xs
    d1 = minimum_image(x1 - x2, box)
    d2 = minimum_image(x3 - x2, box)
    rsq1 = torch.sum(d1 * d1, -1)
    rsq2 = torch.sum(d2 * d2, -1)
    r1 = torch.sqrt(torch.clamp(rsq1, min=1e-30))
    r2 = torch.sqrt(torch.clamp(rsq2, min=1e-30))
    c = torch.clamp(torch.sum(d1 * d2, -1) / (r1 * r2), -1.0, 1.0)
    return d1, d2, rsq1, rsq2, r1, r2, c


class DihedralStyle(BondedStyle):
    kind = "dihedral"
    arity = 4
    energy_key = "edihed"


class ImproperStyle(BondedStyle):
    kind = "improper"
    arity = 4
    energy_key = "eimp"


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
    packages.  On the grid FENE rides the LJ+FENE pair kernel; on the
    matrix engine it runs per tuple (BondStyle.tuple_terms over
    bond_fn)."""

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
class AngleHarmonic(AngleStyle):
    """E = K (theta - theta0)^2 (src/angle_harmonic.cpp)."""

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
        d1, d2, rsq1, rsq2, r1, r2, c = angle_geometry(xs, box)
        k = self.table(self.k, r1)[ttype]
        th0 = self.table(self.theta0, r1)[ttype]
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
            dub = minimum_image(xs[2] - xs[0], box)
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
class DihedralHarmonic(DihedralStyle):
    """E = K[1 + d cos(n phi)] (src/dihedral_harmonic.cpp)."""

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
    reads_types = True

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
        (_, types, q), idx, take = view
        w = self.table(self.weight, xs[0])[ttype]
        pair = ctx.pair
        it = member_column(take, types, idx[0]).long()
        jt = member_column(take, types, idx[3]).long()
        q1 = member_column(take, q, idx[0])
        q4 = member_column(take, q, idx[3])
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
class ImproperHarmonic(ImproperStyle):
    """E = K (chi - chi0)^2 (src/MOLECULE/improper_harmonic.cpp)."""

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



# ----------------------------------------------------- more bond styles
@register_bonded("bond", "morse")
class BondMorse(BondStyle):
    """E = D (1 - exp(-a(r-r0)))^2 (src/MOLECULE/bond_morse.cpp)."""

    name = "morse"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.d0 = np.zeros(ntypes + 1)
        self.alpha = np.zeros(ntypes + 1)
        self.r0 = np.zeros(ntypes + 1)

    def coeff(self, btype, d0, alpha, r0):
        self.d0[btype] = d0
        self.alpha[btype] = alpha
        self.r0[btype] = r0

    def bond_fn(self, r2, btype):
        d0 = self.per(self.d0, r2, btype)
        al = self.per(self.alpha, r2, btype)
        r0 = self.per(self.r0, r2, btype)
        r = torch.sqrt(r2)
        ralpha = torch.exp(-al * (r - r0))
        fbond = torch.where(r > 0, -2.0 * d0 * al * (1 - ralpha) * ralpha
                            / r, 0.0)
        return fbond, d0 * (1 - ralpha) ** 2


@register_bonded("bond", "gromos")
class BondGromos(BondStyle):
    """E = 0.25 K (r^2 - r0^2)^2 (src/MOLECULE/bond_gromos.cpp)."""

    name = "gromos"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.r0 = np.zeros(ntypes + 1)

    def coeff(self, btype, k, r0):
        self.k[btype] = k
        self.r0[btype] = r0

    def bond_fn(self, r2, btype):
        k = self.per(self.k, r2, btype)
        r0 = self.per(self.r0, r2, btype)
        dr = r2 - r0 * r0
        return -2.0 * k * dr, 0.25 * k * dr * dr


@register_bonded("bond", "fene/expand")
class BondFENEExpand(BondStyle):
    """FENE with a shift delta: the spring and LJ act on r - delta
    (src/MOLECULE/bond_fene_expand.cpp)."""

    name = "fene/expand"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.r0 = np.zeros(ntypes + 1)
        self.epsilon = np.zeros(ntypes + 1)
        self.sigma = np.zeros(ntypes + 1)
        self.shift = np.zeros(ntypes + 1)

    def coeff(self, btype, k, r0, epsilon, sigma, shift):
        self.k[btype] = k
        self.r0[btype] = r0
        self.epsilon[btype] = epsilon
        self.sigma[btype] = sigma
        self.shift[btype] = shift

    def bond_fn(self, r2, btype):
        k, r0, eps, sig, sh = (self.per(a, r2, btype) for a in (
            self.k, self.r0, self.epsilon, self.sigma, self.shift))
        r = torch.sqrt(r2)
        rshift = r - sh
        rshiftsq = rshift * rshift
        r0sq = r0 * r0
        rlogarg = torch.clamp(1.0 - rshiftsq / r0sq, min=0.1)
        rs = torch.clamp(r, min=1e-30)
        fbond = -k * rshift / rlogarg / rs
        ebond = -0.5 * k * r0sq * torch.log(rlogarg)
        sr2 = sig * sig / torch.clamp(rshiftsq, min=1e-30)
        sr6 = sr2 * sr2 * sr2
        inside = rshiftsq < 2.0 ** (1.0 / 3.0) * sig * sig
        fbond = fbond + torch.where(
            inside, 48.0 * eps * sr6 * (sr6 - 0.5)
            / torch.where(rshift == 0, 1.0, rshift) / rs, 0.0)
        ebond = ebond + torch.where(
            inside, 4.0 * eps * sr6 * (sr6 - 1.0) + eps, 0.0)
        return fbond, ebond


@register_bonded("bond", "zero")
class BondZero(BondStyle):
    """Topology-only placeholder (src/bond_zero.cpp)."""

    name = "zero"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.r0 = np.zeros(ntypes + 1)  # for SHAKE

    def coeff(self, btype, *vals):
        if vals:
            self.r0[btype] = vals[0]

    def bond_fn(self, r2, btype):
        z = torch.zeros_like(r2)
        return z, z


@register_bonded("bond", "nonlinear")
class BondNonlinear(BondStyle):
    """E = eps dr^2 / (lambda^2 - dr^2)
    (src/EXTRA-MOLECULE/bond_nonlinear.cpp)."""

    name = "nonlinear"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.epsilon = np.zeros(ntypes + 1)
        self.r0 = np.zeros(ntypes + 1)
        self.lamda = np.zeros(ntypes + 1)

    def coeff(self, btype, epsilon, r0, lamda):
        self.epsilon[btype] = epsilon
        self.r0[btype] = r0
        self.lamda[btype] = lamda

    def bond_fn(self, r2, btype):
        eps = self.per(self.epsilon, r2, btype)
        r0 = self.per(self.r0, r2, btype)
        lam = self.per(self.lamda, r2, btype)
        r = torch.sqrt(r2)
        dr = r - r0
        drsq = dr * dr
        lamsq = lam * lam
        denom = torch.clamp(lamsq - drsq, min=1e-30)
        fbond = -eps / torch.clamp(r, min=1e-30) * 2.0 * dr * lamsq \
            / (denom * denom)
        return fbond, eps * drsq / denom


@register_bonded("bond", "quartic")
class BondQuartic(BondStyle):
    """Breakable quartic bond (src/MOLECULE/bond_quartic.cpp:60-180):
      E = K (r-Rc)^2 (r-Rc-B1)(r-Rc-B2) + U0
        + [4 sr6 (sr6-1) + 1]            for r^2 < 2^(1/3)  (WCA core)
        - E_pair(r)                      (the pair style's single)
    A bond breaks for good once r > Rc.  The pair term of an intact bond
    is subtracted (the deck sets special_bonds 1 1 1) and tallied as pair
    energy.  ``alive`` (M,) bool on the device, one per tuple, is carried
    state: the set-up makes it and keeps it over later set-ups, and
    md/fixes.py::FixBondBreak clears a bond's entry after the position
    update, before the force evaluation (tpumd/md/fixes.py:60-86)."""

    name = "quartic"
    breakable = True
    reads_types = True

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.b1 = np.zeros(ntypes + 1)
        self.b2 = np.zeros(ntypes + 1)
        self.rc = np.zeros(ntypes + 1)
        self.u0 = np.zeros(ntypes + 1)
        self.alive = None

    def coeff(self, btype, k, b1, b2, rc, u0):
        self.k[btype] = k
        self.b1[btype] = b1
        self.b2[btype] = b2
        self.rc[btype] = rc
        self.u0[btype] = u0

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        (_, types, _), idx, take = view
        d = minimum_image(xs[0] - xs[1], box)
        r2 = torch.sum(d * d, dim=-1)
        live = (torch.ones_like(r2, dtype=torch.bool) if self.alive is None
                else self.alive)
        r2 = torch.where(live, r2, 1.0)
        k, b1, b2, rc, u0 = (self.per(a, r2, ttype) for a in (
            self.k, self.b1, self.b2, self.rc, self.u0))
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        dr = r - rc
        ra = dr - b1
        rb = dr - b2
        fbond = -k / r * (dr * dr * (ra + rb) + 2.0 * dr * ra * rb)
        eb = k * dr * dr * ra * rb + u0
        wca = r2 < 2.0 ** (1.0 / 3.0)
        sr2 = torch.where(wca, 1.0, 0.0) / torch.where(wca, r2, 1.0)
        sr6 = sr2 * sr2 * sr2
        fbond = fbond + 48.0 * sr6 * (sr6 - 0.5) * sr2
        eb = eb + torch.where(wca, 4.0 * sr6 * (sr6 - 1.0) + 1.0, 0.0)
        # the pair interaction of the intact bonded pair is taken out
        fp, esub = ctx.pair.single(r2, member_column(take, types, idx[0]),
                                   member_column(take, types, idx[1]))
        fbond = torch.where(live, fbond - fp, 0.0)
        f1 = fbond[:, None] * d
        ed = None
        if eflag:
            ed = {self.energy_key: torch.where(live, eb, 0.0),
                  "evdwl": -torch.where(live, esub, 0.0)}
        return [f1, -f1], ed, [(d, f1)] if vflag else None

    def break_bonds(self, xs, ttype, box):
        """Clear alive where a bond is stretched past Rc (no host sync)."""
        d = minimum_image(xs[0] - xs[1], box)
        rc = self.per(self.rc, d, ttype)
        self.alive &= torch.sum(d * d, dim=-1) <= rc * rc


# ---------------------------------------------------- more angle styles
@register_bonded("angle", "cosine/squared")
class AngleCosineSquared(AngleStyle):
    """E = K (cos theta - cos theta0)^2
    (src/MOLECULE/angle_cosine_squared.cpp)."""

    name = "cosine/squared"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.theta0 = np.zeros(ntypes + 1)

    def coeff(self, atype, k, theta0_deg):
        self.k[atype] = k
        self.theta0[atype] = theta0_deg * np.pi / 180.0

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = angle_geometry(xs, box)
        c = geo[-1]
        k = self.per(self.k, c, ttype)
        dcostheta = c - torch.cos(self.per(self.theta0, c, ttype))
        tk = k * dcostheta
        return self.angle_terms(geo, 2.0 * tk, tk * dcostheta, eflag,
                             vflag)


@register_bonded("angle", "zero")
class AngleZero(AngleStyle):
    """Topology-only placeholder (src/angle_zero.cpp)."""

    name = "zero"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.theta0 = np.zeros(ntypes + 1)

    def coeff(self, atype, *vals):
        if vals:
            self.theta0[atype] = float(vals[0]) * np.pi / 180.0

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        return self.zero_terms(xs, eflag, vflag)


@register_bonded("angle", "cosine")
class AngleCosine(AngleStyle):
    """E = K (1 + cos theta) (src/MOLECULE/angle_cosine.cpp)."""

    name = "cosine"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.theta0 = np.full(ntypes + 1, np.pi)

    def coeff(self, atype, k):
        self.k[atype] = k

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = angle_geometry(xs, box)
        c = geo[-1]
        k = self.per(self.k, c, ttype)
        return self.angle_terms(geo, k, k * (1.0 + c), eflag, vflag)


@register_bonded("angle", "cosine/periodic")
class AngleCosinePeriodic(AngleStyle):
    """DREIDING periodic cosine: E = C [1 - B (-1)^n cos(n theta)]
    via Chebyshev recurrences (src/EXTRA-MOLECULE/
    angle_cosine_periodic.cpp:106-140; k = C / n^2)."""

    name = "cosine/periodic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.b = np.zeros(ntypes + 1)
        self.mult = np.zeros(ntypes + 1, np.int64)

    def coeff(self, atype, c, b, n):
        n = int(n)
        self.k[atype] = c / (n * n)
        self.b[atype] = b
        self.mult[atype] = n

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = angle_geometry(xs, box)
        c = geo[-1]
        k = self.per(self.k, c, ttype)
        b = self.per(self.b, c, ttype)
        mm = self.table(self.mult, c, torch.int64)[ttype]
        # T_m(c) and the reference's scaled-U recurrence, picked per type
        # by multiplicity, the m = 1 case included (:117-140)
        mmax = int(self.mult.max()) if self.mult.max() > 0 else 1
        tn_1, tn_2 = c, torch.ones_like(c)
        un_1 = torch.full_like(c, 2.0)
        un_2 = torch.zeros_like(c)
        tsel = torch.where(mm == 1, tn_1, 0.0)
        usel = torch.where(mm == 1, 1.0, 0.0)
        for m in range(2, mmax + 1):
            tn = 2.0 * c * tn_1 - tn_2
            tn_2, tn_1 = tn_1, tn
            un = 2.0 * c * un_1 - un_2
            un_2, un_1 = un_1, un
            tsel = tsel + torch.where(mm == m, tn, 0.0)
            usel = usel + torch.where(mm == m, un, 0.0)
        sign = torch.where(mm % 2 == 0, 1.0, -1.0).to(c.dtype)
        tn = b * sign * tsel
        un = b * sign * mm.to(c.dtype) * usel
        return self.angle_terms(geo, -k * un, 2.0 * k * (1.0 - tn),
                             eflag, vflag)

    @property
    def theta0(self):
        return np.pi * (1.0 - np.where(self.b > 0, 0.0, 1.0 / np.maximum(
            self.mult, 1)))


@register_bonded("angle", "quartic")
class AngleQuartic(AngleStyle):
    """E = K2 dt^2 + K3 dt^3 + K4 dt^4
    (src/EXTRA-MOLECULE/angle_quartic.cpp)."""

    name = "quartic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.theta0 = np.zeros(ntypes + 1)
        self.k2 = np.zeros(ntypes + 1)
        self.k3 = np.zeros(ntypes + 1)
        self.k4 = np.zeros(ntypes + 1)

    def coeff(self, atype, theta0_deg, k2, k3, k4):
        self.theta0[atype] = theta0_deg * np.pi / 180.0
        self.k2[atype] = k2
        self.k3[atype] = k3
        self.k4[atype] = k4

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = angle_geometry(xs, box)
        c = geo[-1]
        th0, k2, k3, k4 = (self.per(a, c, ttype) for a in (
            self.theta0, self.k2, self.k3, self.k4))
        sinv = 1.0 / torch.clamp(torch.sqrt(1.0 - c * c), min=0.001)
        dth = torch.arccos(c) - th0
        dth2 = dth * dth
        dth3 = dth2 * dth
        tk = 2.0 * k2 * dth + 3.0 * k3 * dth2 + 4.0 * k4 * dth3
        e = k2 * dth2 + k3 * dth3 + k4 * dth3 * dth
        return self.angle_terms(geo, -tk * sinv, e, eflag, vflag)


# ------------------------------------------------- more dihedral styles
_SBS_SMALL = 0.001


def _sbs_geometry(xs, box):
    """The reference's second dihedral formulation (opls, multi/harmonic,
    cvff): two bond angles and their sines (dihedral_opls.cpp:120-180)."""
    x1, x2, x3, x4 = xs
    vb1 = minimum_image(x1 - x2, box)
    vb2 = minimum_image(x3 - x2, box)
    vb2m = -vb2
    vb3 = minimum_image(x4 - x3, box)

    def dot(a, b):
        return torch.sum(a * b, -1)
    sb1 = 1.0 / torch.clamp(dot(vb1, vb1), min=1e-30)
    sb2 = 1.0 / torch.clamp(dot(vb2, vb2), min=1e-30)
    sb3 = 1.0 / torch.clamp(dot(vb3, vb3), min=1e-30)
    rb1 = torch.sqrt(sb1)
    rb3 = torch.sqrt(sb3)
    c0 = dot(vb1, vb3) * rb1 * rb3
    b1mag = torch.sqrt(dot(vb1, vb1))
    b2mag = torch.sqrt(dot(vb2, vb2))
    b3mag = torch.sqrt(dot(vb3, vb3))
    r12c1 = 1.0 / torch.clamp(b1mag * b2mag, min=1e-30)
    c1mag = dot(vb1, vb2) * r12c1
    r12c2 = 1.0 / torch.clamp(b2mag * b3mag, min=1e-30)
    c2mag = dot(vb2m, vb3) * r12c2
    sc1 = torch.sqrt(torch.clamp(1.0 - c1mag * c1mag, min=0.0))
    sc1 = 1.0 / torch.clamp(sc1, min=_SBS_SMALL)
    sc2 = torch.sqrt(torch.clamp(1.0 - c2mag * c2mag, min=0.0))
    sc2 = 1.0 / torch.clamp(sc2, min=_SBS_SMALL)
    s1 = sc1 * sc1
    s2 = sc2 * sc2
    s12 = sc1 * sc2
    c = torch.clamp((c0 + c1mag * c2mag) * s12, -1.0, 1.0)
    return (vb1, vb2, vb2m, vb3, sb1, sb2, sb3, rb1, rb3, c0,
            r12c1, r12c2, c1mag, c2mag, s1, s2, s12, c)


def _sbs_forces(geo, a):
    """Member forces for a = dE/dc (dihedral_opls.cpp:183-210)."""
    (vb1, vb2, vb2m, vb3, sb1, sb2, sb3, rb1, rb3, c0,
     r12c1, r12c2, c1mag, c2mag, s1, s2, s12, c) = geo
    c = c * a
    s12 = s12 * a
    a11 = c * sb1 * s1
    a22 = -sb2 * (2.0 * c0 * s12 - c * (s1 + s2))
    a33 = c * sb3 * s2
    a12 = -r12c1 * (c1mag * c * s1 + c2mag * s12)
    a13 = -rb1 * rb3 * s12
    a23 = r12c2 * (c2mag * c * s2 + c1mag * s12)
    sx2 = (a12[:, None] * vb1 + a22[:, None] * vb2
           + a23[:, None] * vb3)
    f1 = a11[:, None] * vb1 + a12[:, None] * vb2 + a13[:, None] * vb3
    f2 = -sx2 - f1
    f4 = a13[:, None] * vb1 + a23[:, None] * vb2 + a33[:, None] * vb3
    f3 = sx2 - f4
    return [f1, f2, f3, f4]


@register_bonded("dihedral", "opls")
class DihedralOPLS(DihedralStyle):
    """OPLS: E = 1/2[K1(1+cos p) + K2(1-cos 2p) + K3(1+cos 3p)
    + K4(1-cos 4p)] (src/MOLECULE/dihedral_opls.cpp; the 1/2 is folded
    into the stored coefficients as coeff :282 does)."""

    name = "opls"
    _SMALLER = 0.00001

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros((ntypes + 1, 4))

    def coeff(self, dtype_, k1, k2, k3, k4):
        self.k[dtype_] = 0.5 * np.array([k1, k2, k3, k4])

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = _sbs_geometry(xs, box)
        c = geo[-1]
        k1, k2, k3, k4 = self.per(self.k, c, ttype).unbind(-1)
        phi = torch.arccos(c)
        si = torch.sin(phi)
        si = torch.where(torch.abs(si) < self._SMALLER, self._SMALLER, si)
        siinv = 1.0 / si
        p = (k1 * (1.0 + c) + k2 * (1.0 - torch.cos(2.0 * phi))
             + k3 * (1.0 + torch.cos(3.0 * phi))
             + k4 * (1.0 - torch.cos(4.0 * phi)))
        pd = (k1 - 2.0 * k2 * torch.sin(2.0 * phi) * siinv
              + 3.0 * k3 * torch.sin(3.0 * phi) * siinv
              - 4.0 * k4 * torch.sin(4.0 * phi) * siinv)
        return self.dihedral_terms(_sbs_forces(geo, pd), geo[0], geo[1],
                                   geo[3], p, eflag, vflag)


@register_bonded("dihedral", "multi/harmonic")
class DihedralMultiHarmonic(DihedralStyle):
    """E = sum_{n=1..5} A_n cos^{n-1}(phi)
    (src/MOLECULE/dihedral_multi_harmonic.cpp:160-178)."""

    name = "multi/harmonic"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.a = np.zeros((ntypes + 1, 5))

    def coeff(self, dtype_, a1, a2, a3, a4, a5):
        self.a[dtype_] = (a1, a2, a3, a4, a5)

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = _sbs_geometry(xs, box)
        c = geo[-1]
        a1, a2, a3, a4, a5 = self.per(self.a, c, ttype).unbind(-1)
        p = a1 + c * (a2 + c * (a3 + c * (a4 + c * a5)))
        pd = a2 + c * (2.0 * a3 + c * (3.0 * a4 + c * 4.0 * a5))
        return self.dihedral_terms(_sbs_forces(geo, pd), geo[0], geo[1],
                                   geo[3], p, eflag, vflag)


@register_bonded("dihedral", "zero")
class DihedralZero(DihedralStyle):
    """Topology-only placeholder (src/dihedral_zero.cpp)."""

    name = "zero"

    def coeff(self, dtype_, *vals):
        pass

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        return self.zero_terms(xs, eflag, vflag)


# ------------------------------------------------- more improper styles
@register_bonded("improper", "cvff")
class ImproperCVFF(ImproperStyle):
    """E = K[1 + d cos(n omega)] on the dihedral-like improper angle
    (src/MOLECULE/improper_cvff.cpp:155-230)."""

    name = "cvff"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.sign = np.zeros(ntypes + 1)
        self.mult = np.zeros(ntypes + 1, dtype=np.int32)

    def coeff(self, itype, k, d, n):
        self.k[itype] = k
        self.sign[itype] = d
        self.mult[itype] = int(n)

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = _sbs_geometry(xs, box)
        c = geo[-1]
        k = self.per(self.k, c, ttype)
        sign = self.per(self.sign, c, ttype)
        m = self.table(self.mult, c, torch.int32)[ttype]
        rc2 = c * c
        # p = 1 +/- cos(n omega) and pd = dp/dc / 2 per multiplicity
        p_tab = [2.0 * torch.ones_like(c),
                 c + 1.0,
                 2.0 * rc2,
                 (4.0 * rc2 - 3.0) * c + 1.0,
                 8.0 * (rc2 - 1.0) * rc2 + 2.0,
                 ((16.0 * rc2 - 20.0) * rc2 + 5.0) * c + 1.0,
                 ((32.0 * rc2 - 48.0) * rc2 + 18.0) * rc2]
        pd_tab = [torch.zeros_like(c),
                  0.5 * torch.ones_like(c),
                  2.0 * c,
                  6.0 * rc2 - 1.5,
                  (16.0 * rc2 - 8.0) * c,
                  (40.0 * rc2 - 30.0) * rc2 + 2.5,
                  (96.0 * (rc2 - 1.0) * rc2 + 18.0) * c]
        p = torch.zeros_like(c)
        pd = torch.zeros_like(c)
        for mm in range(7):
            p = torch.where(m == mm, p_tab[mm], p)
            pd = torch.where(m == mm, pd_tab[mm], pd)
        neg = sign < 0
        p = torch.where(neg, 2.0 - p, p)
        pd = torch.where(neg, -pd, pd)
        return self.dihedral_terms(_sbs_forces(geo, 2.0 * k * pd), geo[0],
                                   geo[1], geo[3], k * p, eflag, vflag)


@register_bonded("improper", "umbrella")
class ImproperUmbrella(ImproperStyle):
    """Wilson out-of-plane umbrella (DREIDING inversion),
    src/MOLECULE/improper_umbrella.cpp:40-240.  Atom 1 is the center;
    E = K(1-cos w) for w0=0 else 0.5 C (cos w - cos w0)^2."""

    name = "umbrella"
    _SMALL = 0.001

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.kw = np.zeros(ntypes + 1)
        self.w0 = np.zeros(ntypes + 1)
        self.C = np.zeros(ntypes + 1)

    def coeff(self, itype, k, w0_deg):
        w = w0_deg * np.pi / 180.0
        self.kw[itype] = k
        self.w0[itype] = w
        # C = k/sin(w0)^2 (coeff :269)
        self.C[itype] = k / (np.sin(w) ** 2) if w != 0.0 else k

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        x1, x2, x3, x4 = xs
        vb1 = minimum_image(x2 - x1, box)
        vb2 = minimum_image(x3 - x1, box)
        vb3 = minimum_image(x4 - x1, box)

        def dot(a, b):
            return torch.sum(a * b, -1)
        a_v = torch.linalg.cross(vb1, vb2)
        ra = torch.clamp(torch.sqrt(dot(a_v, a_v)), min=self._SMALL)
        rh = torch.clamp(torch.sqrt(dot(vb3, vb3)), min=self._SMALL)
        ar = a_v / ra[:, None]
        hr = vb3 / rh[:, None]
        c = torch.clamp(dot(ar, hr), -1.0, 1.0)
        sv = torch.clamp(torch.sqrt(1.0 - c * c), min=self._SMALL)
        cotphi = c / sv
        projhfg = (dot(vb3, vb1) / torch.clamp(torch.sqrt(dot(vb1, vb1)),
                                               min=1e-30)
                   + dot(vb3, vb2) / torch.clamp(torch.sqrt(dot(vb2, vb2)),
                                                 min=1e-30))
        flip = projhfg > 0.0
        sv = torch.where(flip, -sv, sv)
        cotphi = torch.where(flip, -cotphi, cotphi)
        kw = self.per(self.kw, c, ttype)
        w0 = self.per(self.w0, c, ttype)
        cc = self.per(self.C, c, ttype)
        is_flat = w0 == 0.0
        domega = sv - torch.cos(w0)
        a_half = 0.5 * cc * domega
        e = torch.where(is_flat, kw * (1.0 - sv), a_half * domega)
        a = torch.where(is_flat, -kw, 2.0 * a_half) * cotphi
        dha = hr - c[:, None] * ar
        dah = ar - c[:, None] * hr
        rar = (1.0 / ra)[:, None]
        rhr = (1.0 / rh)[:, None]
        f2 = torch.linalg.cross(dha, vb1) * rar * a[:, None]
        f3 = -torch.linalg.cross(dha, vb2) * rar * a[:, None]
        f4 = dah * rhr * a[:, None]
        f1 = -(f2 + f3 + f4)
        # the reference applies f3 to atom i2 and f2 to atom i3
        # (:196-215) and tallies the virial on the standard dihedral bond
        # vectors with (f1, f2, f4) (:218-233)
        vp = None
        if vflag:
            vb1s = minimum_image(x1 - x2, box)
            vb2s = minimum_image(x3 - x2, box)
            vb3s = minimum_image(x4 - x3, box)
            vp = [(vb1s, f1), (vb2s, f2), (vb3s + vb2s, f4)]
        return ([f1, f3, f2, f4], {self.energy_key: e} if eflag else None,
                vp)


@register_bonded("improper", "zero")
class ImproperZero(ImproperStyle):
    """Topology-only placeholder (src/improper_zero.cpp)."""

    name = "zero"

    def coeff(self, itype, *vals):
        pass

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        return self.zero_terms(xs, eflag, vflag)


# --------------------------------------------------------------- hybrid
class _Hybrid:
    """bond/angle/dihedral/improper_style hybrid s1 s2 ...
    (src/bond_hybrid.cpp, angle_hybrid.cpp, dihedral_hybrid.cpp,
    improper_hybrid.cpp): each type maps to one sub-style, named first on
    its coeff line; ``none`` leaves a type without interaction.  parts()
    hands each sub-style its own tuples."""

    name = "hybrid"

    def __init__(self, ntypes, sub_names=()):
        from tpumd_torch.models.registry import create_bonded_style
        super().__init__(ntypes)
        if not sub_names:
            raise ValueError(f"{self.kind}_style hybrid needs sub-styles")
        self.sub_names = list(sub_names)
        self.subs = [create_bonded_style(self.kind, n, (), ntypes)
                     for n in self.sub_names]
        self.type_map = np.full(ntypes + 1, -1, dtype=np.int64)

    def coeff(self, ttype, subname, *vals):
        subname = str(subname)
        if subname == "none":
            self.type_map[ttype] = -1
            return
        if subname not in self.sub_names:
            raise ValueError(f"{self.kind}_coeff {ttype} {subname}: not a "
                             f"sub-style of {self.sub_names}")
        k = self.sub_names.index(subname)
        self.type_map[ttype] = k
        self.subs[k].coeff(ttype, *vals)

    def init(self):
        super().init()
        for sub in self.subs:
            sub.units = getattr(self, "units", None)
            sub.init()

    def parts(self, tuples):
        tm = self.type_map[np.asarray(tuples)[:, 0]]
        out = []
        for k, sub in enumerate(self.subs):
            out += sub.parts(np.asarray(tuples)[tm == k])
        return out

    def merged(self, name):
        """A per-type table of the sub-styles' (r0, theta0 for SHAKE)."""
        out = np.zeros(self.type_map.shape[0])
        for t, k in enumerate(self.type_map):
            if k >= 0 and hasattr(self.subs[k], name):
                out[t] = getattr(self.subs[k], name)[t]
        return out


@register_bonded("bond", "hybrid")
class BondHybrid(_Hybrid, BondStyle):
    @property
    def r0(self):
        return self.merged("r0")


@register_bonded("angle", "hybrid")
class AngleHybrid(_Hybrid, AngleStyle):
    @property
    def theta0(self):
        return self.merged("theta0")


@register_bonded("dihedral", "hybrid")
class DihedralHybrid(_Hybrid, DihedralStyle):
    pass


@register_bonded("improper", "hybrid")
class ImproperHybrid(_Hybrid, ImproperStyle):
    pass
