"""fix shake: SHAKE bond and angle constraints.

PyTorch counterpart of tpumd/md/fix_shake.py (the reference's
src/RIGID/fix_shake.cpp): clusters of 2, 3 and 4 atoms (and the 3-atom
angle variant) are found once from the bond topology, selected by bond
type, atom type, mass or angle type, and each step's constraint forces
solve the reference's quadratic equations: the 2-atom case in closed form,
the others by the same fixed-point iteration, written as batched matrix
products over a kind's clusters (l <- A^-1 (b - q(l)), the quadratic forms
as (clusters, m, m, m) tensors), so an iteration is a few operations
whatever the cluster size.  The iteration runs its full count with
per-cluster freezing once converged (no flag is read back from the
device).  Clusters are stored in tag space and mapped to the engine's
rows at each call (``row2slot_from_tags``: the cell grid's slots or the
matrix engine's rows alike); they are disjoint, so the force scatter has
no collisions.  The constraint virial rides the fix state.

fix rattle (``FixRattle``) adds RATTLE's velocity constraints to the same
clusters: each cluster's linear system, solved exactly, at post_force,
and SHAKE's coordinate constraint force at final_integrate.

On the grid with the tag-matched bonded path (``StepContext.bonded_grid``,
ops/cellgrid_tuples.py; tpumd/md/fix_shake.py:173-217, 353-): each atom
carries its cluster's member tags, kind, its own role and the
constraint distances in ``MDState.peratom`` (``install_grid_tables``),
finds its members among the grid's slots by tag, solves its whole cluster
and keeps only its own force delta and 1/size of the cluster's virial:
nothing is scattered, so a rank's local grid solves its owned atoms'
clusters, their members' velocities and forces refilled into the halo
slots from the owners once a call (``GridDecomp.exchange_vf``).  On the
matrix engine's row blocks (``RowDecomp``) every rank solves every
cluster on the gathered rows and keeps its own rows' forces, the virial
counted on rank 0.  The fix state is the constraint virial (6) and,
seventh, the count of clusters since the set-up that lacked a member on
the grid (``device_flags``).  fix rattle has no grid path (as in tpumd,
:774): across ranks it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import MDState, minimum_image
from tpumd_torch.md.fixes import Fix
from tpumd_torch.models.bonded import voigt
from tpumd_torch.ops.cellgrid import row2slot_from_tags
from tpumd_torch.ops.cellgrid_tuples import copies_of, member_slots

# the per-atom tables of the tag-matched path: the cluster's member tags
# (4, 0-padded), its kind (0: none, 2, 3, 5 the angle cluster, 4), the
# atom's role and the cluster's distances (3: the bonds, the angle
# cluster's 1-2 distance third)
GRID_KEYS = ("_shk_mtags", "_shk_kind", "_shk_role", "_shk_dist")
# kind code: (members, the distance columns it reads)
GRID_KINDS = {2: (2, (0,)), 3: (3, (0, 1)), 5: (3, (0, 1, 2)),
              4: (4, (0, 1, 2))}


def _dot(a, b):
    return torch.sum(a * b, -1)


class FixShake(Fix):
    name = "shake"
    contributes_virial = True

    def __init__(self, tol, max_iter, output_every=0, b_types=(),
                 a_types=(), t_types=(), masses=()):
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.b_types = set(b_types)
        self.a_types = set(a_types)
        self.t_types = set(t_types)
        self.masses = list(masses)
        self._built = False
        self._ndof_removed = 0

    @classmethod
    def parse(cls, args):
        """fix ID group shake tol iter N [b ...] [a ...] [t ...] [m ...]"""
        tol, max_iter, output = float(args[0]), int(args[1]), int(args[2])
        lists = {"b": [], "a": [], "t": [], "m": []}
        cur = None
        for tok in args[3:]:
            if tok in lists:
                cur = tok
            elif cur is None:
                raise NotImplementedError(
                    f"fix shake keyword {tok!r} is not ported")
            else:
                lists[cur].append(float(tok) if cur == "m" else int(tok))
        return cls(tol, max_iter, output, lists["b"], lists["a"],
                   lists["t"], lists["m"])

    @property
    def dof_removed(self):
        return self._ndof_removed

    # ------------------------------------------------------------- build
    def build_clusters(self, bonds, angles, types, mass, bond_r0,
                       angle_theta0=None):
        """Find the constraint clusters (FixShake::find_clusters).

        bonds (M, 3) and angles (A, 4) hold a type and 1-based tags; types
        (natoms,) the atom types by tag-1; mass the per-type masses;
        bond_r0 / angle_theta0 the styles' equilibrium tables.  Cluster
        members are stored as tag-1.  Returns the data-file rows of the
        constrained bonds and angles, which the bonded styles skip (the
        reference negates their types)."""
        def mass_match(m):
            return any(abs(m - mv) <= 0.1 for mv in self.masses)

        cons = []  # (a, b, btype) as tag-1
        excl_bonds = []
        for ib, (bt, t1, t2) in enumerate(np.asarray(bonds)):
            a, b = int(t1) - 1, int(t2) - 1
            if (int(bt) in self.b_types or int(types[a]) in self.t_types
                    or int(types[b]) in self.t_types
                    or mass_match(mass[types[a]])
                    or mass_match(mass[types[b]])):
                cons.append((a, b, int(bt)))
                excl_bonds.append(ib)

        # central atom: the one with more constrained bonds, on a tie the
        # heavier (H is the satellite)
        nbonds_of = {}
        for a, b, _ in cons:
            nbonds_of[a] = nbonds_of.get(a, 0) + 1
            nbonds_of[b] = nbonds_of.get(b, 0) + 1
        by_center: dict[int, list] = {}
        for a, b, bt in cons:
            center, sat = (a, b) if nbonds_of[a] >= nbonds_of[b] else (b, a)
            if nbonds_of[a] == nbonds_of[b]:
                center, sat = ((a, b) if mass[types[a]] >= mass[types[b]]
                               else (b, a))
            by_center.setdefault(center, []).append((sat, bt))

        # angle-constrained clusters: a centre with two bonds whose angle
        # type is selected (water)
        angle_of_center = {}
        excl_angles = []
        if angles is not None and self.a_types:
            for ia, (at, _, t2, _) in enumerate(np.asarray(angles)):
                if int(at) in self.a_types:
                    angle_of_center[int(t2) - 1] = int(at)
                    excl_angles.append(ia)

        c2, c3, c4, c3a = [], [], [], []
        ndof = 0
        for center, sats in by_center.items():
            if len(sats) == 1:
                c2.append((center, sats[0][0], sats[0][1]))
                ndof += 1
            elif len(sats) == 2 and center in angle_of_center:
                c3a.append((center, sats[0][0], sats[1][0], sats[0][1],
                            sats[1][1], angle_of_center[center]))
                ndof += 3
            elif len(sats) == 2:
                c3.append((center, sats[0][0], sats[1][0], sats[0][1],
                           sats[1][1]))
                ndof += 2
            elif len(sats) == 3:
                c4.append((center, sats[0][0], sats[1][0], sats[2][0],
                           sats[0][1], sats[1][1], sats[2][1]))
                ndof += 3
            else:
                raise ValueError(f"SHAKE cluster of more than 4 atoms "
                                 f"(centre tag {center + 1})")
        self._ndof_removed = ndof
        self._c2 = np.asarray(c2, dtype=np.int64).reshape(-1, 3)
        self._c3 = np.asarray(c3, dtype=np.int64).reshape(-1, 5)
        self._c4 = np.asarray(c4, dtype=np.int64).reshape(-1, 7)
        self._c3a = np.asarray(c3a, dtype=np.int64).reshape(-1, 6)
        self._bond_dist = np.asarray(bond_r0, np.float64)
        if len(c3a):
            d01 = self._bond_dist[self._c3a[:, 3]]
            d02 = self._bond_dist[self._c3a[:, 4]]
            th = np.asarray(angle_theta0)[self._c3a[:, 5]]
            self._angle_dist = np.sqrt(d01 * d01 + d02 * d02
                                       - 2.0 * d01 * d02 * np.cos(th))
        else:
            self._angle_dist = np.zeros(0)
        self._built = True
        self._dev = {}
        return excl_bonds, excl_angles

    def counts(self):
        """Clusters of size 2, 3 (two bonds), 3 with the angle, 4."""
        return (len(self._c2), len(self._c3), len(self._c3a),
                len(self._c4))

    def grid_tables(self, natoms: int):
        """The per-atom tables of the tag-matched path (GRID_KEYS) in tag
        order, numpy: each cluster's member tags, kind, the atom's role
        and the cluster's distances."""
        mtags = np.zeros((natoms, 4), np.int32)
        kind = np.zeros(natoms, np.int32)
        role = np.zeros(natoms, np.int32)
        dist = np.zeros((natoms, 3), np.float64)
        bd = self._bond_dist
        for rows, nat, code, dists in (
                (self._c2, 2, 2, [bd[self._c2[:, 2]]]),
                (self._c3, 3, 3, [bd[self._c3[:, 3]], bd[self._c3[:, 4]]]),
                (self._c3a, 3, 5, [bd[self._c3a[:, 3]], bd[self._c3a[:, 4]],
                                   self._angle_dist]),
                (self._c4, 4, 4, [bd[self._c4[:, k]] for k in (4, 5, 6)])):
            for ro in range(nat):
                a = rows[:, ro]
                mtags[a, :nat] = rows[:, :nat] + 1
                kind[a] = code
                role[a] = ro
                dist[a, :len(dists)] = np.stack(dists, axis=1)
        return mtags, kind, role, dist

    def install_grid_tables(self, sim):
        """The per-atom tables of the tag-matched path in the rows of
        sim.state, which then ride the atoms."""
        order = sim.state.tag.cpu().numpy() - 1
        dev = sim.device
        tables = [torch.as_tensor(a[order], device=dev)
                  for a in self.grid_tables(sim.natoms)]
        tables[3] = tables[3].to(sim.dtype)
        sim.state = sim.state.replace(peratom={
            **(sim.state.peratom or {}), **dict(zip(GRID_KEYS, tables))})

    def _tables(self, like):
        """Cluster members (tag-1) and distances on like's device."""
        key = (like.dtype, like.device)
        if key not in self._dev:
            def ints(a):
                return torch.as_tensor(a, dtype=torch.int64,
                                       device=like.device)

            def floats(a):
                return torch.as_tensor(np.asarray(a, np.float64),
                                       dtype=like.dtype, device=like.device)
            bd = self._bond_dist
            self._dev[key] = {
                2: (ints(self._c2[:, :2]), [floats(bd[self._c2[:, 2]])]),
                3: (ints(self._c3[:, :3]), [floats(bd[self._c3[:, k]])
                                            for k in (3, 4)]),
                5: (ints(self._c3a[:, :3]), [floats(bd[self._c3a[:, 3]]),
                                             floats(bd[self._c3a[:, 4]]),
                                             floats(self._angle_dist)]),
                4: (ints(self._c4[:, :4]), [floats(bd[self._c4[:, k]])
                                            for k in (4, 5, 6)])}
        return self._dev[key]

    # ------------------------------------------------------------- solve
    flag_message = ("a SHAKE cluster lacked a member among the grid's "
                    "slots (a member more than a cell away)")

    def init_state(self, s, ctx):
        return torch.zeros(7, dtype=s.x.dtype, device=s.x.device)

    def virial_contrib(self, fstate):
        return fstate[:6]

    def device_flags(self, fstate):
        return fstate[6]

    def post_force(self, s, fstate, ctx, xin=None):
        # fstate := this step's constraint virial, the lost-member count
        # carried on
        s, out = self._apply(s, ctx, ctx.dt * ctx.dt * ctx.units.ftm2v)
        return s, out + torch.cat([out.new_zeros(6), fstate[6:]])

    def setup_post_force(self, s, fstate, ctx, xin=None):
        """FixShake::setup = correct_coordinates + shake_end_of_step
        (src/RIGID/fix_shake.cpp:461-503).  With v = f = 0 the solve
        projects x onto the constraints, applied as a position move; the
        step-0 energies stay those of the uncorrected coordinates (the
        reference computes forces before modify->setup).  Then the
        constraint forces with the velocity-Verlet half prefactor."""
        dtfsq = 0.5 * ctx.dt * ctx.dt * ctx.units.ftm2v
        zero = torch.zeros_like(s.f)
        s0, _ = self._apply(s.replace(f=zero, v=zero), ctx, dtfsq)
        invm = 1.0 / ctx.mass_per_atom(s)
        s = s.replace(x=s.x + (dtfsq * invm)[:, None] * s0.f)
        if ctx.decomp is not None and ctx.is_cellgrid:
            # the halo slots follow their owners' corrected positions
            s = s.replace(x=ctx.decomp.exchange_positions(s.x, s.box))
        return self._apply(s, ctx, dtfsq)

    def _apply(self, s, ctx, dtfsq):
        """(state with the constraint forces added, (7,) the constraint
        virial and the count of clusters that lacked a member): the
        tag-matched path on the grid where its tables ride the state, the
        gathered rows on a rank's block of matrix rows, else every
        cluster by the rows of its members' tags."""
        if ctx.bonded_grid and GRID_KEYS[0] in (s.peratom or {}):
            return self._apply_grid(s, ctx, dtfsq)
        if ctx.decomp is not None and ctx.decomp.kind == "rows":
            return self._apply_rows(s, ctx, dtfsq)
        s, virial = self._apply_slots(s, ctx, dtfsq)
        return s, torch.cat([virial, virial.new_zeros(1)])

    def _apply_rows(self, s, ctx, dtfsq):
        """_apply on a rank's block of matrix rows: every cluster solved on
        every row's x, v and f (one all-gather), the rank's rows' forces
        kept, the virial counted on rank 0."""
        dec = ctx.decomp
        allr = dec.gather_rows(torch.cat([s.x, s.v, s.f], dim=1))
        full = MDState(x=allr[:, :3], v=allr[:, 3:6], f=allr[:, 6:],
                       type=dec.type_all, tag=dec.tag_all,
                       image=torch.zeros_like(allr[:, :3], dtype=torch.int32),
                       box=s.box)
        full, virial = self._apply_slots(full, ctx, dtfsq)
        return (s.replace(f=full.f[dec.r0:dec.r1]),
                torch.cat([dec.once(virial), virial.new_zeros(1)]))

    def _apply_grid(self, s, ctx, dtfsq):
        """_apply by each slot's own cluster (GRID_KEYS), its members found
        by tag among the grid's slots: each member solves the cluster and
        keeps its own delta and 1/size of the virial; safe stand-in
        members keep the other slots' solves finite."""
        mtags, kind, role, dist = (s.peratom[k] for k in GRID_KEYS)
        slots, found = member_slots(s.x, s.tag, mtags, copies_of(ctx))
        v, f = s.v, s.f
        if ctx.decomp is not None:
            v, f = ctx.decomp.exchange_vf(v, f)
        invm = 1.0 / ctx.mass_per_atom(s)
        X, IM = s.x[slots], invm[slots]
        XS = X + ctx.dt * v[slots] + (dtfsq * IM)[..., None] * f[slots]
        box = s.box

        def dvec(xa, xb):
            return minimum_image(xa - xb, box)

        safe = torch.cat([s.x.new_zeros((1, 3)),
                          torch.eye(3, dtype=s.x.dtype, device=s.x.device)])
        solvers = {2: self._solve2, 3: self._solve3, 5: self._solve3angle,
                   4: self._solve4}
        live = dict(zip((2, 3, 5, 4), self.counts()))
        fdelta = torch.zeros_like(s.f)
        virial = s.x.new_zeros(6)
        lost = s.x.new_zeros(())
        for code, (nat, cols) in GRID_KINDS.items():
            if not live[code]:
                continue
            sel = kind == code
            sel3 = sel[:, None]
            xk = [torch.where(sel3, X[:, k], safe[k]) for k in range(nat)]
            xsk = [torch.where(sel3, XS[:, k], safe[k]) for k in range(nat)]
            imk = [torch.where(sel, IM[:, k], 1.0) for k in range(nat)]
            dd = [torch.where(sel, dist[:, c], 1.0) for c in cols]
            lamrs, deltas = solvers[code](xk, xsk, imk, dtfsq, dd, dvec)
            own = torch.gather(torch.stack(deltas), 0, role.long().view(
                1, -1, 1).expand(1, -1, 3))[0]
            fdelta = fdelta + torch.where(sel3, own, 0.0)
            lam = torch.stack([torch.where(sel, p[0], 0.0) / nat
                               for p in lamrs], dim=1)
            r = torch.stack([p[1] for p in lamrs], dim=1)
            virial = virial + voigt(torch.einsum("nk,nki,nkj->ij", lam, r,
                                                 r))
            lost = lost + torch.sum(sel & ~torch.all(found[:, :nat], dim=1))
        return s.replace(f=s.f + fdelta), torch.cat([virial, lost[None]])

    def _apply_slots(self, s, ctx, dtfsq):
        """(state with the constraint forces added, constraint virial) of
        every cluster, its members at the rows of their tags."""
        dt_ = s.x.dtype
        slot = row2slot_from_tags(s.tag, ctx.natoms)
        invm_all = 1.0 / ctx.mass_per_atom(s)
        xshake_all = s.x + ctx.dt * s.v + (dtfsq * invm_all)[:, None] * s.f
        box = s.box
        f = s.f.clone()
        virial = torch.zeros(6, dtype=dt_, device=s.x.device)

        def dvec(xa, xb):
            return minimum_image(xa - xb, box)

        solvers = {2: self._solve2, 3: self._solve3, 5: self._solve3angle,
                   4: self._solve4}
        for kind, (members, dists) in self._tables(s.x).items():
            if members.shape[0] == 0:
                continue
            idx = [slot[members[:, k]] for k in range(members.shape[1])]
            X = [s.x[i] for i in idx]
            XS = [xshake_all[i] for i in idx]
            IM = [invm_all[i] for i in idx]
            lamrs, deltas = solvers[kind](X, XS, IM, dtfsq, dists, dvec)
            for i, dlt in zip(idx, deltas):
                f.index_add_(0, i, dlt)
            # sum over constraints of lam r_a r_b, one contraction a kind
            lam = torch.stack([p[0] for p in lamrs], dim=1)
            r = torch.stack([p[1] for p in lamrs], dim=1)
            virial = virial + voigt(torch.einsum("nk,nki,nkj->ij", lam, r,
                                                 r))
        return s.replace(f=f), virial

    @staticmethod
    def _solve2(X, XS, IM, dtfsq, dists, dvec):
        """Closed-form 2-atom solve (FixShake::shake)."""
        bond = dists[0]
        r01 = dvec(X[0], X[1])
        s01 = dvec(XS[0], XS[1])
        im0, im1 = IM
        a = (im0 + im1) ** 2 * _dot(r01, r01)
        b = 2.0 * (im0 + im1) * _dot(s01, r01)
        c = _dot(s01, s01) - bond * bond
        sq = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
        l1 = (-b + sq) / (2.0 * a)
        l2 = (-b - sq) / (2.0 * a)
        lam = torch.where(torch.abs(l1) <= torch.abs(l2), l1, l2) / dtfsq
        return [(lam, r01)], [lam[:, None] * r01, -lam[:, None] * r01]

    def _iterate(self, quad, binit, ainv):
        """The shared fixed-point iteration (FixShake::shake3/shake4/
        shake3angle): l <- A^-1 (b - q(l)) with q_k(l) = l^T Q_k l, for
        max_iter rounds; a cluster's multipliers freeze once every change
        is within tol.  quad (n, m, m, m) holds each Q_k upper-triangular,
        ainv (n, m, m), binit (n, m); returns l (n, m)."""
        lam = torch.zeros_like(binit)
        done = torch.zeros(binit.shape[:1], dtype=torch.bool,
                           device=binit.device)
        for _ in range(self.max_iter):
            qv = torch.einsum("nkij,ni,nj->nk", quad, lam, lam)
            new = torch.einsum("nkj,nj->nk", ainv, binit - qv)
            conv = torch.all(torch.abs(new - lam) <= self.tol, dim=1)
            lam = torch.where(done[:, None], lam, new)
            done = done | conv
        return lam

    @staticmethod
    def _inv3(a):
        """Cofactor inverse of a 3x3 system per cluster: a (n, 3, 3)."""
        a11, a12, a13 = a[:, 0].unbind(1)
        a21, a22, a23 = a[:, 1].unbind(1)
        a31, a32, a33 = a[:, 2].unbind(1)
        det = (a11 * a22 * a33 + a12 * a23 * a31 + a13 * a21 * a32
               - a11 * a23 * a32 - a12 * a21 * a33 - a13 * a22 * a31)
        cof = torch.stack([
            a22 * a33 - a23 * a32, -(a12 * a33 - a13 * a32),
            a12 * a23 - a13 * a22,
            -(a21 * a33 - a23 * a31), a11 * a33 - a13 * a31,
            -(a11 * a23 - a13 * a21),
            a21 * a32 - a22 * a31, -(a11 * a32 - a12 * a31),
            a11 * a22 - a12 * a21], dim=1).reshape(-1, 3, 3)
        return cof / det[:, None, None]

    @staticmethod
    def _quad(diag, off):
        """(n, m, m, m) upper-triangular quadratic forms from, per form k,
        its diagonal diag[k] (m entries) and off-diagonal terms off[k]
        {(i, j): coefficient of l_i l_j}."""
        n = diag[0][0].shape[0]
        m = len(diag)
        q = diag[0][0].new_zeros((n, m, m, m))
        for k in range(m):
            for i in range(m):
                q[:, k, i, i] = diag[k][i]
            for (i, j), c in off[k].items():
                q[:, k, i, j] = c
        return q

    def _solve3(self, X, XS, IM, dtfsq, dists, dvec):
        """Two bonds from a centre (FixShake::shake3)."""
        bond1, bond2 = dists
        r01, r02 = dvec(X[0], X[1]), dvec(X[0], X[2])
        s01, s02 = dvec(XS[0], XS[1]), dvec(XS[0], XS[2])
        im0, im1, im2 = IM
        a11 = 2.0 * (im0 + im1) * _dot(s01, r01)
        a12 = 2.0 * im0 * _dot(s01, r02)
        a21 = 2.0 * im0 * _dot(s02, r01)
        a22 = 2.0 * (im0 + im2) * _dot(s02, r02)
        dinv = 1.0 / (a11 * a22 - a12 * a21)
        ainv = torch.stack([a22 * dinv, -a12 * dinv, -a21 * dinv,
                            a11 * dinv], dim=1).reshape(-1, 2, 2)
        r01sq, r02sq, r0102 = _dot(r01, r01), _dot(r02, r02), _dot(r01, r02)
        quad = self._quad(
            [((im0 + im1) ** 2 * r01sq, im0 * im0 * r02sq),
             (im0 * im0 * r01sq, (im0 + im2) ** 2 * r02sq)],
            [{(0, 1): 2.0 * (im0 + im1) * im0 * r0102},
             {(0, 1): 2.0 * (im0 + im2) * im0 * r0102}])
        binit = torch.stack([bond1 * bond1 - _dot(s01, s01),
                             bond2 * bond2 - _dot(s02, s02)], dim=1)
        l01, l02 = (self._iterate(quad, binit, ainv) / dtfsq).unbind(1)
        return ([(l01, r01), (l02, r02)],
                [l01[:, None] * r01 + l02[:, None] * r02,
                 -l01[:, None] * r01, -l02[:, None] * r02])

    def _solve3angle(self, X, XS, IM, dtfsq, dists, dvec):
        """Two bonds and the angle (FixShake::shake3angle)."""
        bond1, bond2, bond12 = dists
        r01, r02, r12 = (dvec(X[0], X[1]), dvec(X[0], X[2]),
                         dvec(X[1], X[2]))
        s01, s02, s12 = (dvec(XS[0], XS[1]), dvec(XS[0], XS[2]),
                         dvec(XS[1], XS[2]))
        im0, im1, im2 = IM
        ainv = self._inv3(torch.stack([
            2.0 * (im0 + im1) * _dot(s01, r01), 2.0 * im0 * _dot(s01, r02),
            -2.0 * im1 * _dot(s01, r12),
            2.0 * im0 * _dot(s02, r01), 2.0 * (im0 + im2) * _dot(s02, r02),
            2.0 * im2 * _dot(s02, r12),
            -2.0 * im1 * _dot(s12, r01), 2.0 * im2 * _dot(s12, r02),
            2.0 * (im1 + im2) * _dot(s12, r12)], dim=1).reshape(-1, 3, 3))
        r01sq, r02sq, r12sq = _dot(r01, r01), _dot(r02, r02), _dot(r12, r12)
        r0102, r0112, r0212 = _dot(r01, r02), _dot(r01, r12), _dot(r02, r12)
        quad = self._quad(
            [((im0 + im1) ** 2 * r01sq, im0 * im0 * r02sq,
              im1 * im1 * r12sq),
             (im0 * im0 * r01sq, (im0 + im2) ** 2 * r02sq,
              im2 * im2 * r12sq),
             (im1 * im1 * r01sq, im2 * im2 * r02sq,
              (im1 + im2) ** 2 * r12sq)],
            [{(0, 1): 2.0 * (im0 + im1) * im0 * r0102,
              (0, 2): -2.0 * (im0 + im1) * im1 * r0112,
              (1, 2): -2.0 * im0 * im1 * r0212},
             {(0, 1): 2.0 * (im0 + im2) * im0 * r0102,
              (0, 2): 2.0 * im0 * im2 * r0112,
              (1, 2): 2.0 * (im0 + im2) * im2 * r0212},
             {(0, 1): -2.0 * im1 * im2 * r0102,
              (0, 2): -2.0 * (im1 + im2) * im1 * r0112,
              (1, 2): 2.0 * (im1 + im2) * im2 * r0212}])
        binit = torch.stack([bond1 * bond1 - _dot(s01, s01),
                             bond2 * bond2 - _dot(s02, s02),
                             bond12 * bond12 - _dot(s12, s12)], dim=1)
        l01, l02, l12 = (self._iterate(quad, binit, ainv)
                         / dtfsq).unbind(1)
        return ([(l01, r01), (l02, r02), (l12, r12)],
                [l01[:, None] * r01 + l02[:, None] * r02,
                 -l01[:, None] * r01 + l12[:, None] * r12,
                 -l02[:, None] * r02 - l12[:, None] * r12])

    def _solve4(self, X, XS, IM, dtfsq, dists, dvec):
        """Three bonds from a centre (FixShake::shake4)."""
        b1, b2, b3 = dists
        r01, r02, r03 = (dvec(X[0], X[1]), dvec(X[0], X[2]),
                         dvec(X[0], X[3]))
        s01, s02, s03 = (dvec(XS[0], XS[1]), dvec(XS[0], XS[2]),
                         dvec(XS[0], XS[3]))
        im0, im1, im2, im3 = IM
        ainv = self._inv3(torch.stack([
            2.0 * (im0 + im1) * _dot(s01, r01), 2.0 * im0 * _dot(s01, r02),
            2.0 * im0 * _dot(s01, r03),
            2.0 * im0 * _dot(s02, r01), 2.0 * (im0 + im2) * _dot(s02, r02),
            2.0 * im0 * _dot(s02, r03),
            2.0 * im0 * _dot(s03, r01), 2.0 * im0 * _dot(s03, r02),
            2.0 * (im0 + im3) * _dot(s03, r03)], dim=1).reshape(-1, 3, 3))
        r01sq, r02sq, r03sq = _dot(r01, r01), _dot(r02, r02), _dot(r03, r03)
        r0102, r0103, r0203 = _dot(r01, r02), _dot(r01, r03), _dot(r02, r03)
        i00 = im0 * im0
        quad = self._quad(
            [((im0 + im1) ** 2 * r01sq, i00 * r02sq, i00 * r03sq),
             (i00 * r01sq, (im0 + im2) ** 2 * r02sq, i00 * r03sq),
             (i00 * r01sq, i00 * r02sq, (im0 + im3) ** 2 * r03sq)],
            [{(0, 1): 2.0 * (im0 + im1) * im0 * r0102,
              (0, 2): 2.0 * (im0 + im1) * im0 * r0103,
              (1, 2): 2.0 * i00 * r0203},
             {(0, 1): 2.0 * (im0 + im2) * im0 * r0102,
              (0, 2): 2.0 * i00 * r0103,
              (1, 2): 2.0 * (im0 + im2) * im0 * r0203},
             {(0, 1): 2.0 * i00 * r0102,
              (0, 2): 2.0 * (im0 + im3) * im0 * r0103,
              (1, 2): 2.0 * (im0 + im3) * im0 * r0203}])
        binit = torch.stack([b1 * b1 - _dot(s01, s01),
                             b2 * b2 - _dot(s02, s02),
                             b3 * b3 - _dot(s03, s03)], dim=1)
        l01, l02, l03 = (self._iterate(quad, binit, ainv) / dtfsq).unbind(1)
        return ([(l01, r01), (l02, r02), (l03, r03)],
                [l01[:, None] * r01 + l02[:, None] * r02
                 + l03[:, None] * r03,
                 -l01[:, None] * r01, -l02[:, None] * r02,
                 -l03[:, None] * r03])


class FixRattle(FixShake):
    """fix rattle: SHAKE's coordinate constraints plus RATTLE's velocity
    constraints (src/RIGID/fix_rattle.cpp; tpumd/md/fix_shake.py:652-790).

    The hooks follow the reference's setmask: the velocity correction runs
    at post_force, on the unconstrained half-kick prediction
    vp = v + dtf f / m (vrattle*, :147-175), and SHAKE's constraint force
    moves to final_integrate (:213-217), after the integrator's last half
    kick, so it acts on the next step's positions while this step's
    velocities are corrected directly; list ``fix rattle`` after the
    integrator.  Each cluster's 2x2 or 3x3 system is solved exactly
    (solve2x2exactly, solve3x3exactly), batched over a kind's clusters;
    clusters stay in tag space and map to the slots at each call."""

    name = "rattle"

    def post_force(self, s, fstate, ctx, xin=None):
        dtfv = 0.5 * ctx.dt * ctx.units.ftm2v
        invm = 1.0 / ctx.mass_per_atom(s)
        vp = torch.addcmul(s.v, (dtfv * invm)[:, None], s.f)
        slot = row2slot_from_tags(s.tag, ctx.natoms)
        box = s.box
        v = s.v.clone()
        for kind, (members, _) in self._tables(s.x).items():
            if members.shape[0] == 0:
                continue
            idx = [slot[members[:, k]] for k in range(members.shape[1])]
            i0 = idx[0]
            im = [invm[i] for i in idx]
            if kind == 5:
                # the angle cluster: bonds 0-1, 0-2 and the 1-2 distance
                pairs = ((1, 0), (2, 0), (2, 1))
            else:
                pairs = tuple((k, 0) for k in range(1, len(idx)))
            r = [minimum_image(s.x[idx[a]] - s.x[idx[b]], box)
                 for a, b in pairs]
            c = [-_dot(vp[idx[a]] - vp[idx[b]], rk)
                 for (a, b), rk in zip(pairs, r)]
            if kind == 2:
                lam = [c[0] / (_dot(r[0], r[0]) * (im[0] + im[1]))]
            elif kind == 3:
                a11 = (im[1] + im[0]) * _dot(r[0], r[0])
                a12 = im[0] * _dot(r[0], r[1])
                a22 = (im[0] + im[2]) * _dot(r[1], r[1])
                det = a11 * a22 - a12 * a12
                lam = [(c[0] * a22 - c[1] * a12) / det,
                       (a11 * c[1] - a12 * c[0]) / det]
            else:
                # the symmetric 3x3 system, solved by its cofactor inverse
                # (solve3x3exactly)
                if kind == 5:
                    r01, r02, r12 = r
                    d = ((im[1] + im[0]) * _dot(r01, r01),
                         (im[0] + im[2]) * _dot(r02, r02),
                         (im[2] + im[1]) * _dot(r12, r12))
                    o = (im[0] * _dot(r01, r02), -im[1] * _dot(r01, r12),
                         im[2] * _dot(r02, r12))
                else:
                    r01, r02, r03 = r
                    d = ((im[0] + im[1]) * _dot(r01, r01),
                         (im[0] + im[2]) * _dot(r02, r02),
                         (im[0] + im[3]) * _dot(r03, r03))
                    o = (im[0] * _dot(r01, r02), im[0] * _dot(r01, r03),
                         im[0] * _dot(r02, r03))
                ainv = self._inv3(torch.stack(
                    [d[0], o[0], o[1], o[0], d[1], o[2], o[1], o[2], d[2]],
                    dim=1).reshape(-1, 3, 3))
                lam = torch.einsum("nkj,nj->nk", ainv,
                                   torch.stack(c, dim=1)).unbind(1)
            # each constraint (a, b) moves b against r and a along it:
            # v_a += im_a l r, v_b -= im_b l r, with r = x_a - x_b
            dv = {k: torch.zeros_like(r[0]) for k in range(len(idx))}
            for (a, b), lk, rk in zip(pairs, lam, r):
                d = lk[:, None] * rk
                dv[a] = dv[a] + d
                dv[b] = dv[b] - d
            for k, i in enumerate(idx):
                v.index_add_(0, i, im[k][:, None] * dv[k])
        return s.replace(v=v), fstate

    def final_integrate(self, s, fstate, ctx):
        """SHAKE's coordinate constraint force, after the integrator's last
        kick; RATTLE keeps the half dtfsq prefactor (fix_shake.cpp:485-486:
        ``if (!rattle) dtfsq = dt*dt*ftm2v``).  The fix state becomes this
        constraint virial."""
        return self._apply(s, ctx, 0.5 * ctx.dt * ctx.dt * ctx.units.ftm2v)
