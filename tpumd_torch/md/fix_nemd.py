"""NEMD and thermal fixes: thermal/conductivity, viscosity (Muller-Plathe
reverse NEMD), heat, oneway and vector.

The port of tpumd/md/fix_nemd.py (src/fix_thermal_conductivity.cpp,
src/EXTRA-FIX/fix_viscosity.cpp, src/fix_heat.cpp,
src/EXTRA-FIX/fix_oneway.cpp, src/fix_vector.cpp).  tpumd copies x, v and
type to the host at every Nevery; here each swap or rescale is a few
tensor operations at ``end_of_step`` on the card, in the fixes' deck order
as Modify::end_of_step runs them, with no read back to the host: the
slab picks are masked argmax/argmin reductions, the exchange happens in
the pair's centre-of-mass frame, and the exchanged energy or momentum
(the fix's ``f_ID``) accumulates in a float64 device scalar that thermo's
packed read picks up (``device_output``).  Ties between equal candidates
go to the atom first in the reference's row order (``ctx.ref_order_tags``,
the set-up's spatial sort), as the reference's storage-order scan admits
only a strict improvement and tpumd's stable sort keeps that order.
fix heat's negative-energy error rides the run's one flag read a segment
(``device_flags``).  fix vector reads its inputs on the host at its steps,
as tpumd does.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.region import BlockRegion, OutsideRegion
from tpumd_torch.md.fixes import Fix, fix_state

BIG = 1.0e10  # fix_viscosity.cpp:35, fix_thermal_conductivity.cpp:32
_AXES = {"x": 0, "y": 1, "z": 2}


class DeviceNemd(Fix):
    """An end_of_step fix that acts every nevery steps on the card; its
    state is (step, accumulated f_ID as a float64 () tensor, rank of each
    tag in the reference's row order)."""

    needs_step = True

    def init_state(self, s, ctx):
        order = ctx.ref_order_tags
        rank = torch.zeros(int(order.max()) + 1, dtype=torch.int64)
        rank[torch.as_tensor(order, dtype=torch.int64)] = torch.arange(
            len(order))
        return (0, torch.zeros((), dtype=torch.float64, device=s.x.device),
                rank.to(s.x.device))

    def set_step(self, fstate, istep):
        return (istep,) + tuple(fstate[1:])

    def device_output(self, fstate):
        return fstate[1]

    def output(self, sim):
        fs = fix_state(sim, self)
        return 0.0 if fs is None else float(fs[1])

    def _slab(self, s, dim, k, nbin):
        """(N,) bool: atoms of the fix's group in slab k of nbin along
        dim, their coordinate folded into the box once."""
        lo, hi = s.box.lo[dim], s.box.hi[dim]
        prd = hi - lo
        c = s.x[:, dim]
        c = torch.where(c < lo, c + prd, c)
        c = torch.where(c >= hi, c - prd, c)
        binsize = prd / nbin
        return self.group_sel(s) & (c >= lo + k * binsize) \
            & (c < lo + (k + 1) * binsize)

    @staticmethod
    def _picks(key, sel, rank, n):
        """The rows of the n largest key within sel, ties to the lowest
        rank, each a (1,) int64 tensor, and whether each exists, (1,) bool
        (every index a tensor: nothing is read back)."""
        out = []
        for _ in range(n):
            kmax = torch.amax(torch.where(sel, key, -torch.inf))
            cand = sel & (key == kmax)
            best = torch.argmin(torch.where(cand, rank, rank.max() + 1))
            best = best.reshape(1)
            out.append((best, torch.any(cand).reshape(1)))
            sel = sel.index_fill(0, best, False)
        return out

    def _rank(self, s, fstate):
        return fstate[2][s.tag.long()]


class FixThermalConductivity(DeviceNemd):
    """fix ID group thermal/conductivity N edim Nbin [swap Nswap]: every N
    steps the hottest atoms of the cold slab (bin 0) and the coldest of
    the hot slab (bin Nbin/2) exchange their velocities in each pair's
    centre-of-mass frame (fix_thermal_conductivity.cpp:140-260); f_ID is
    the kinetic energy moved so far."""

    name = "thermal/conductivity"

    def __init__(self, nevery, edim, nbin, nswap=1):
        self.nevery = int(nevery)
        self.edim = _AXES[edim]
        self.nbin = int(nbin)
        if self.nbin % 2 or self.nbin <= 2:
            raise ValueError("fix thermal/conductivity: Nbin must be even "
                             "and > 2")
        self.nswap = int(nswap)

    def end_of_step(self, s, fstate, ctx):
        step, total, rank_t = fstate
        if step % self.nevery:
            return s, fstate
        m = ctx.mass_per_atom(s)
        ke = 0.5 * m * torch.sum(s.v * s.v, dim=1)
        rank = self._rank(s, fstate)
        lo = self._picks(ke, self._slab(s, self.edim, 0, self.nbin), rank,
                         self.nswap)
        hi = self._picks(-ke, self._slab(s, self.edim, self.nbin // 2,
                                         self.nbin), rank, self.nswap)
        v, de = s.v, 0.0
        for (i, fi), (j, fj) in zip(lo, hi):
            good = (fi & fj)[:, None]
            mi = m.index_select(0, i)[:, None]
            mj = m.index_select(0, j)[:, None]
            vi, vj = s.v.index_select(0, i), s.v.index_select(0, j)
            vcm = (mi * vi + mj * vj) / (mi + mj)
            v = v.index_put((i,), torch.where(good, 2.0 * vcm - vi,
                                              v.index_select(0, i)))
            v = v.index_put((j,), torch.where(good, 2.0 * vcm - vj,
                                              v.index_select(0, j)))
            de = de + torch.sum(torch.where(
                good, mj * vcm * (vcm - vj) - mi * vcm * (vcm - vi), 0.0))
        total = total + ctx.units.mvv2e * de.to(torch.float64)
        return s.replace(v=v), (step, total, rank_t)


class FixViscosity(DeviceNemd):
    """fix ID group viscosity N vdim pdim Nbin [swap Nswap] [vtarget V]:
    every N steps the vdim component closest to +vtarget in the lo slab
    (among atoms moving with +vdim) and the one closest to -vtarget in the
    slab at Nbin/2 (moving with -vdim) exchange in the pair's
    centre-of-mass frame (fix_viscosity.cpp:150-280); f_ID is the momentum
    moved so far.  The distance to vtarget is taken in float64: the
    default BIG (1e10, not infinity) leaves |v - 1e10| resolvable there,
    not in float32."""

    name = "viscosity"

    def __init__(self, nevery, vdim, pdim, nbin, nswap=1, vtarget=BIG):
        self.nevery = int(nevery)
        self.vdim, self.pdim = _AXES[vdim], _AXES[pdim]
        self.nbin = int(nbin)
        if self.nbin % 2 or self.nbin <= 2:
            raise ValueError("fix viscosity: Nbin must be even and > 2")
        self.nswap = int(nswap)
        self.vtarget = float(vtarget)

    def end_of_step(self, s, fstate, ctx):
        step, total, rank_t = fstate
        if step % self.nevery:
            return s, fstate
        m = ctx.mass_per_atom(s)
        vv = s.v[:, self.vdim]
        v64 = vv.to(torch.float64)
        rank = self._rank(s, fstate)
        pos = self._picks(
            -torch.abs(v64 - self.vtarget),
            self._slab(s, self.pdim, 0, self.nbin) & (vv >= 0.0), rank,
            self.nswap)
        neg = self._picks(
            -torch.abs(v64 + self.vtarget),
            self._slab(s, self.pdim, self.nbin // 2, self.nbin) & (vv <= 0.0),
            rank, self.nswap)
        col, dp = vv.clone(), 0.0
        for (ip, fp), (jn, fn) in zip(pos, neg):
            good = fp & fn
            mp, mn = m.index_select(0, ip), m.index_select(0, jn)
            vp, vn = vv.index_select(0, ip), vv.index_select(0, jn)
            vcm = (mn * vn + mp * vp) / (mn + mp)
            col = col.index_put((jn,), torch.where(
                good, 2.0 * vcm - vn, col.index_select(0, jn)))
            col = col.index_put((ip,), torch.where(
                good, 2.0 * vcm - vp, col.index_select(0, ip)))
            dp = dp + torch.sum(torch.where(
                good, mp * (vcm - vp) - mn * (vcm - vn), 0.0))
        v = s.v.clone()
        v[:, self.vdim] = col
        return s.replace(v=v), (step, total + dp.to(torch.float64), rank_t)


class FixHeat(DeviceNemd):
    """fix ID group heat N eflux: every N steps the group's velocities are
    rescaled about its centre-of-mass velocity so that its kinetic energy
    gains eflux * N * dt (fix_heat.cpp:140-200, constant style).  A
    kinetic energy driven negative is flagged on the card and raises at
    the segment's end."""

    name = "heat"

    def __init__(self, nevery, flux):
        self.nevery = int(nevery)
        self.flux = float(flux)

    def init_state(self, s, ctx):
        step, total, rank = super().init_state(s, ctx)
        return (step, torch.zeros((), dtype=torch.bool, device=s.x.device),
                rank)

    def device_output(self, fstate):
        return None

    def device_flags(self, fstate):
        """() bool on the card: the rescale went negative."""
        return fstate[1]

    flag_message = "Fix heat kinetic energy went negative"

    def end_of_step(self, s, fstate, ctx):
        step, bad, rank = fstate
        if step % self.nevery:
            return s, fstate
        u = ctx.units
        sel = self.group_sel(s)
        m = torch.where(sel, ctx.mass_per_atom(s), 0.0)
        v = s.v
        masstotal = torch.sum(m)
        ke = 0.5 * torch.sum(m * torch.sum(v * v, dim=1)) * u.mvv2e * u.ftm2v
        vcm = torch.sum(m[:, None] * v, dim=0) / masstotal
        vcmsq = torch.dot(vcm, vcm)
        heat = self.flux * self.nevery * ctx.dt * u.ftm2v
        escale = (ke + heat - 0.5 * vcmsq * masstotal) / (
            ke - 0.5 * vcmsq * masstotal)
        scale = torch.sqrt(torch.clamp(escale, min=0.0))
        v = torch.where(sel[:, None], scale * v - (scale - 1.0) * vcm, v)
        return s.replace(v=v), (step, bad | (escale < 0.0), rank)


class FixOneway(DeviceNemd):
    """fix ID group oneway N region-ID [-]x|y|z: every N steps each atom of
    the group inside the region moving against the direction has that
    velocity component flipped (fix_oneway.cpp end_of_step).  A block
    region (or its outside) is tested on the card; any other region style
    reads the positions to the host at those steps."""

    name = "oneway"

    def __init__(self, nevery, region, direction):
        self.nevery = int(nevery)
        self.region = region
        d = direction.lower()
        self.dim = _AXES[d[-1]]
        self.minus = d.startswith("-")

    def device_output(self, fstate):
        return None

    def _inside(self, x):
        reg, out = self.region, False
        if isinstance(reg, OutsideRegion):
            reg, out = reg.inner, True
        if isinstance(reg, BlockRegion):
            lo = torch.as_tensor(reg.lo, dtype=x.dtype, device=x.device)
            hi = torch.as_tensor(reg.hi, dtype=x.dtype, device=x.device)
            ins = torch.all((x >= lo) & (x <= hi), dim=1)
            return ~ins if out else ins
        return torch.as_tensor(self.region.inside(
            x.detach().cpu().numpy().astype(np.float64)), device=x.device)

    def end_of_step(self, s, fstate, ctx):
        if fstate[0] % self.nevery:
            return s, fstate
        comp = s.v[:, self.dim]
        wrong = comp > 0.0 if self.minus else comp < 0.0
        flip = self.group_sel(s) & self._inside(s.x) & wrong
        v = s.v.clone()
        v[:, self.dim] = torch.where(flip, -comp, comp)
        return s.replace(v=v), fstate


class FixVector(Fix):
    """fix ID group vector N value ...: every N steps a row of global
    values (c_ID, c_ID[i], f_ID, v_name, thermo keywords) is appended to a
    table, read on the host at those steps (src/fix_vector.cpp)."""

    name = "vector"

    def __init__(self, nevery, inputs):
        self.nevery = self.host_every = int(nevery)
        self.inputs = list(inputs)
        self.table: list[list[float]] = []

    def host_end_of_step(self, sim):
        """A row of the current values: a thermo keyword from this step's
        thermo values, as tpumd reads it, a reference through the output
        fixes' resolver."""
        from tpumd_torch.md.fix_ave import resolve_input
        vals = None
        row = []
        for nm in self.inputs:
            if nm[:2] in ("c_", "f_", "v_"):
                row.append(float(resolve_input(sim, nm)))
                continue
            vals = vals or sim.thermo_values()
            row.append(float(vals[nm]))
        self.table.append(row)

    def output(self, sim):
        out = np.asarray(self.table, np.float64)
        return out[:, 0] if len(self.inputs) == 1 else out
