"""The small host fixes: force transforms (setforce, addforce, spring/self,
viscous, spring tether, efield, drag, aveforce, planeforce, lineforce,
indent, enforce2d), recenter, and the end-of-step fixes (momentum,
temp/rescale, temp/berendsen, press/berendsen).

The port of tpumd/md/fix_misc.py (src/fix_setforce.cpp, fix_addforce.cpp,
fix_spring_self.cpp, fix_viscous.cpp, fix_momentum.cpp,
fix_temp_rescale.cpp, fix_temp_berendsen.cpp, fix_press_berendsen.cpp,
fix_spring.cpp, fix_efield.cpp, EXTRA-FIX/fix_drag.cpp, fix_recenter.cpp,
fix_aveforce.cpp, fix_planeforce.cpp, fix_lineforce.cpp, fix_indent.cpp,
fix_enforce2d.cpp), on the device.  Each acts on the atoms of its group;
padded grid slots (type 0) are in no group.  spring/self's anchors ride
``MDState.peratom`` (``history_key``) so that they follow the atoms
through every re-bin.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.md import computes
from tpumd_torch.md.fixes import Fix

# a serial per fix with per-atom tables, so that a fix redefined under
# the same ID starts from tables of its own
SERIALS = itertools.count()


def _masked(s, sel, m):
    """(N,) masses of the selected atoms, 0 elsewhere."""
    return torch.where(sel, m, 0.0)


def _com(s, sel, m):
    """(mass-weighted centre of the selected atoms (3,), their mass)."""
    mm = _masked(s, sel, m)
    mtot = torch.sum(mm)
    return torch.sum(mm[:, None] * s.x, dim=0) / mtot, mtot


class FixSetForce(Fix):
    """fix setforce fx fy fz: each given component of the group's forces
    set to its value; NULL (None) keeps it."""

    name = "setforce"

    def __init__(self, fx, fy, fz):
        self.target = (fx, fy, fz)

    def post_force(self, s, fstate, ctx, xin=None, value=None):
        f = s.f.clone()
        sel = self.group_sel(s)
        for d, val in enumerate(self.target):
            if val is not None:
                f[:, d] = torch.where(sel, val if value is None else value,
                                      f[:, d])
        return s.replace(f=f), fstate

    def post_force_respa_lower(self, s, fstate, ctx):
        """The inner respa levels: the set components zeroed, whatever
        their targets (FixSetForce::post_force_respa; tpumd/md/
        fix_misc.py:40)."""
        return self.post_force(s, fstate, ctx, value=0.0)


class FixAddForce(Fix):
    """fix addforce fx fy fz: a constant force added to the group's atoms."""

    name = "addforce"

    def __init__(self, fx, fy, fz):
        self.add = (float(fx), float(fy), float(fz))

    def post_force(self, s, fstate, ctx, xin=None):
        add = torch.tensor(self.add, dtype=s.x.dtype, device=s.x.device)
        return s.replace(f=self.in_group(s, s.f + add, s.f)), fstate


class FixSpringSelf(Fix):
    """fix spring/self K: each atom tethered to its position at the fix's
    first set-up, f -= K (x - x0); x0 rides MDState.peratom, unwrapped
    there by the image flags so that a wrap does not move it."""

    name = "spring/self"

    def __init__(self, k):
        self.k = float(k)
        self._serial = next(SERIALS)

    @property
    def history_key(self) -> str:
        """The key of the anchors in MDState.peratom."""
        return f"fix {self.id} spring/self {self._serial}"

    def setup_post_force(self, s, fstate, ctx, xin=None):
        return self.post_force(anchored(s, self.history_key), fstate, ctx,
                               xin)

    def post_force(self, s, fstate, ctx, xin=None):
        pull = self.k * (unwrapped(s) - s.peratom[self.history_key])
        return s.replace(f=self.in_group(s, s.f - pull, s.f)), fstate


def unwrapped(s):
    """(N, 3) positions unwrapped by their image flags."""
    return s.x + s.image.to(s.x.dtype) * s.box.lengths


def anchored(s, key):
    """s with its unwrapped positions under key in MDState.peratom, where
    the key is not there yet (a fix's first set-up)."""
    if s.peratom and key in s.peratom:
        return s
    return s.replace(peratom={**(s.peratom or {}), key: unwrapped(s)})


class FixViscous(Fix):
    """fix viscous gamma: a drag f -= gamma v on the group."""

    name = "viscous"

    def __init__(self, gamma):
        self.gamma = float(gamma)

    def post_force(self, s, fstate, ctx, xin=None):
        return s.replace(f=self.in_group(s, s.f - self.gamma * s.v,
                                         s.f)), fstate


class FixMomentum(Fix):
    """fix momentum N linear 1 1 1: the group's centre-of-mass velocity
    removed at the end of every Nth step."""

    name = "momentum"
    needs_step = True

    def __init__(self, every=1):
        self.every = max(int(every), 1)

    def init_state(self, s, ctx):
        return 0

    def set_step(self, fstate, istep):
        return istep

    def end_of_step(self, s, fstate, ctx):
        if fstate % self.every:
            return s, fstate
        sel = self.group_sel(s)
        mm = _masked(s, sel, ctx.mass_per_atom(s))
        vcm = torch.sum(mm[:, None] * s.v, dim=0) / torch.sum(mm)
        return s.replace(v=self.in_group(s, s.v - vcm, s.v)), fstate


def _temperature(s, ctx):
    u = ctx.units
    return computes.temperature(s.v, ctx.mass_per_atom(s), ctx.tdof,
                                u.boltz, u.mvv2e)


class FixTempRescale(Fix):
    """fix temp/rescale N Tstart Tstop window fraction: velocities scaled
    toward Tstart where the temperature leaves the window, as tpumd does
    it: every step, at the start target."""

    name = "temp/rescale"

    def __init__(self, every, t_start, t_stop, window, fraction):
        self.every = int(every)
        self.t_start = float(t_start)
        self.t_stop = float(t_stop)
        self.window = float(window)
        self.fraction = float(fraction)

    def end_of_step(self, s, fstate, ctx):
        t = _temperature(s, ctx)
        lamda = torch.sqrt(torch.clamp(1.0 + self.fraction * (
            self.t_start / torch.clamp(t, min=1e-30) - 1.0), min=0.0))
        out = (torch.abs(t - self.t_start) > self.window) & (t > 0)
        return s.replace(v=s.v * torch.where(out, lamda, 1.0)), fstate


class FixTempBerendsen(Fix):
    """fix temp/berendsen Tstart Tstop damp: v *= sqrt(1 + dt/damp
    (Tstart/T - 1)) at the end of each step, on every atom, at the start
    target (tpumd/md/fix_misc.py:147-165)."""

    name = "temp/berendsen"

    def __init__(self, t_start, t_stop, damp):
        self.t_start = float(t_start)
        self.t_stop = float(t_stop)
        self.damp = float(damp)

    def end_of_step(self, s, fstate, ctx):
        t = _temperature(s, ctx)
        lamda = torch.sqrt(torch.clamp(1.0 + ctx.dt / self.damp * (
            self.t_start / torch.clamp(t, min=1e-30) - 1.0), min=0.0))
        return s.replace(v=s.v * torch.where(t > 0, lamda, 1.0)), fstate


class FixPressBerendsen(Fix):
    """fix press/berendsen: at the end of each step every barostatted axis
    dilates about the box centre by mu = (1 - dt/Pperiod (Ptarget - P) /
    modulus)^(1/3), the atoms with it in lamda coordinates; velocities are
    left as they are.  P is the step's kinetic tensor plus the virial of
    its force evaluation over the volume, coupled to its mean under iso.
    Orthogonal boxes only, as the reference."""

    name = "press/berendsen"
    needs_step = True
    needs_virial = True
    box_change = True
    eos_box_change = True

    def __init__(self, p_flags, p_start, p_stop, p_period,
                 modulus=10.0, couple=False):
        self.p_flags = tuple(bool(f) for f in p_flags)
        self.p_start = tuple(map(float, p_start))
        self.p_stop = tuple(map(float, p_stop))
        self.p_period = tuple(map(float, p_period))
        self.modulus = float(modulus)
        self.couple = bool(couple)

    def init_state(self, s, ctx):
        return {"step": 0, "begin": 0, "end": 0,
                "virial": torch.zeros(6, dtype=s.x.dtype,
                                      device=s.x.device)}

    def set_step(self, fstate, istep):
        return {**fstate, "step": istep}

    def pre_run(self, fstate, begin, end):
        return {**fstate, "begin": begin, "end": end}

    def save_virial(self, fstate, virial):
        return {**fstate, "virial": virial}

    def end_of_step(self, s, fst, ctx):
        u = ctx.units
        m = ctx.mass_per_atom(s)
        box = s.box
        mvv = u.mvv2e * torch.sum(m[:, None] * s.v * s.v, dim=0)
        p_cur = (mvv + fst["virial"][:3]) / box.volume * u.nktv2p
        if self.couple:
            p_cur = (torch.sum(p_cur) / 3.0).expand(3)
        delta = (fst["step"] - fst["begin"]) / max(fst["end"] - fst["begin"],
                                                   1)
        lam = (s.x - box.lo) / box.lengths
        center = 0.5 * (box.lo + box.hi)
        dil = []
        for d in range(3):
            target = self.p_start[d] + delta * (self.p_stop[d]
                                                - self.p_start[d])
            dil.append((1.0 - ctx.dt / self.p_period[d] * (target - p_cur[d])
                        / self.modulus) ** (1.0 / 3.0))
        dil = torch.stack(dil)
        flags = torch.tensor(self.p_flags, device=s.x.device)
        lo = torch.where(flags, (box.lo - center) * dil + center, box.lo)
        hi = torch.where(flags, (box.hi - center) * dil + center, box.hi)
        return s.replace(x=lo + lam * (hi - lo),
                         box=box.replace(lo=lo, hi=hi)), fst


class FixSpring(Fix):
    """fix spring tether K x y z R0: a restoring force on the group's
    centre of mass, spread over its atoms by mass
    (FixSpring::spring_tether, src/fix_spring.cpp); a NULL component pulls
    nowhere.  tpumd keeps no spring energy (its espring stays 0), so
    neither does the port."""

    name = "spring"

    def __init__(self, k, xc, yc, zc, r0):
        self.k = float(k)
        self.pt = (xc, yc, zc)
        self.r0 = float(r0)

    def post_force(self, s, fstate, ctx, xin=None):
        m = ctx.mass_per_atom(s)
        xcm, mtot = _com(s, self.group_sel(s), m)
        d = torch.stack([xcm[c] - self.pt[c] if self.pt[c] is not None
                         else torch.zeros_like(xcm[c]) for c in range(3)])
        r = torch.clamp(torch.linalg.norm(d), min=1e-10)
        fper = self.k * d * (r - self.r0) / r / torch.clamp(mtot, min=1e-30)
        return s.replace(f=self.in_group(s, s.f - fper * m[:, None],
                                         s.f)), fstate


class FixEfield(Fix):
    """fix efield Ex Ey Ez: f += q E on charged atoms (the field already
    times qe2f, as the parser gives it)."""

    name = "efield"

    def __init__(self, ex, ey, ez):
        self.e = (float(ex), float(ey), float(ez))

    def post_force(self, s, fstate, ctx, xin=None):
        if s.q is None:
            return s, fstate
        e = torch.tensor(self.e, dtype=s.x.dtype, device=s.x.device)
        return s.replace(f=self.in_group(s, s.f + s.q[:, None] * e,
                                         s.f)), fstate


class FixDrag(Fix):
    """fix drag x y z fmag delta: a force of magnitude fmag toward the
    point on each group atom farther than delta from it, the nearest image
    taken; a NULL component is left out of the distance."""

    name = "drag"

    def __init__(self, xc, yc, zc, fmag, delta):
        self.pt = (xc, yc, zc)
        self.fmag = float(fmag)
        self.delta = float(delta)

    def post_force(self, s, fstate, ctx, xin=None):
        d = torch.stack([s.x[:, c] - self.pt[c] if self.pt[c] is not None
                         else torch.zeros_like(s.x[:, c])
                         for c in range(3)], dim=1)
        d = minimum_image(d, s.box)
        r = torch.linalg.norm(d, dim=1)
        apply = self.group_sel(s) & (r > self.delta)
        pull = (self.fmag / torch.clamp(r, min=1e-30))[:, None] * d
        return s.replace(f=torch.where(apply[:, None], s.f - pull,
                                       s.f)), fstate


class FixRecenter(Fix):
    """fix recenter x y z: after each position update the group is shifted
    so that its centre of mass sits at the target (INIT: where it was at
    set-up); NULL leaves that axis (box units only)."""

    name = "recenter"

    def __init__(self, xc, yc, zc):
        self.pt = [None if v == "NULL" else v for v in (xc, yc, zc)]

    def init_state(self, s, ctx):
        xcm, _ = _com(s, self.group_sel(s), ctx.mass_per_atom(s))
        target = torch.stack([
            xcm[c] if self.pt[c] in (None, "INIT")
            else torch.tensor(float(self.pt[c]), dtype=s.x.dtype,
                              device=s.x.device) for c in range(3)])
        mask = torch.tensor([0.0 if p is None else 1.0 for p in self.pt],
                            dtype=s.x.dtype, device=s.x.device)
        return target, mask

    def post_integrate(self, s, fstate, ctx):
        target, mask = fstate
        xcm, _ = _com(s, self.group_sel(s), ctx.mass_per_atom(s))
        x = s.x + (target - xcm) * mask
        return s.replace(x=self.in_group(s, x, s.x)), fstate


class FixAveForce(Fix):
    """fix aveforce fx fy fz: every group atom takes the group's mean force
    plus the given value in each given component; NULL leaves it."""

    name = "aveforce"

    def __init__(self, fx, fy, fz):
        self.add = (fx, fy, fz)

    def post_force(self, s, fstate, ctx, xin=None):
        sel = self.group_sel(s)
        n = torch.clamp(torch.sum(sel.to(s.x.dtype)), min=1.0)
        f = s.f.clone()
        for c, val in enumerate(self.add):
            if val is None:
                continue
            ave = torch.sum(torch.where(sel, s.f[:, c], 0.0)) / n
            f[:, c] = torch.where(sel, ave + val, s.f[:, c])
        return s.replace(f=f), fstate


class FixPlaneForce(Fix):
    """fix planeforce nx ny nz: the group's forces kept in the plane normal
    to n."""

    name = "planeforce"

    def __init__(self, nx, ny, nz):
        n = np.asarray([nx, ny, nz], np.float64)
        self.n = n / np.linalg.norm(n)

    def post_force(self, s, fstate, ctx, xin=None):
        n = torch.tensor(self.n, dtype=s.x.dtype, device=s.x.device)
        f = s.f - (s.f @ n)[:, None] * n
        return s.replace(f=self.in_group(s, f, s.f)), fstate


class FixLineForce(Fix):
    """fix lineforce dx dy dz: only the group's force component along d
    kept."""

    name = "lineforce"

    def __init__(self, dx, dy, dz):
        d = np.asarray([dx, dy, dz], np.float64)
        self.d = d / np.linalg.norm(d)

    def post_force(self, s, fstate, ctx, xin=None):
        d = torch.tensor(self.d, dtype=s.x.dtype, device=s.x.device)
        f = (s.f @ d)[:, None] * d
        return s.replace(f=self.in_group(s, f, s.f)), fstate


class FixIndent(Fix):
    """fix indent K sphere x y z R [side out|in]: a spherical indenter
    pushing with F = K dr^2 on the group atoms inside (side out) or outside
    (side in) its surface (src/fix_indent.cpp:215-250), the nearest image
    taken."""

    name = "indent"

    def __init__(self, k, xc, yc, zc, radius, side="out"):
        self.k = float(k)
        self.ctr = (float(xc), float(yc), float(zc))
        self.radius = float(radius)
        self.side = side

    def post_force(self, s, fstate, ctx, xin=None):
        ctr = torch.tensor(self.ctr, dtype=s.x.dtype, device=s.x.device)
        d = minimum_image(s.x - ctr, s.box)
        r = torch.clamp(torch.linalg.norm(d, dim=1), min=1e-30)
        if self.side == "out":
            dr = r - self.radius
            fmag = self.k * dr * dr
        else:
            dr = self.radius - r
            fmag = -self.k * dr * dr
        apply = self.group_sel(s) & (dr < 0.0)
        return s.replace(f=torch.where(apply[:, None], s.f + (fmag / r)[
            :, None] * d, s.f)), fstate


class FixEnforce2D(Fix):
    """fix enforce2d: the group's z force and z velocity zeroed after each
    force evaluation, and on sphere atoms the x and y components of omega
    and torque, so that a ``dimension 2`` run stays in its plane
    (src/fix_enforce2d.cpp:86-118)."""

    name = "enforce2d"

    def post_force(self, s, fstate, ctx, xin=None):
        keep = torch.tensor([1.0, 1.0, 0.0], dtype=s.x.dtype,
                            device=s.x.device)
        s = s.replace(f=self.in_group(s, s.f * keep, s.f),
                      v=self.in_group(s, s.v * keep, s.v))
        spin = 1.0 - keep
        if s.omega is not None:
            s = s.replace(omega=self.in_group(s, s.omega * spin, s.omega))
        if s.torque is not None:
            s = s.replace(torque=self.in_group(s, s.torque * spin, s.torque))
        return s, fstate
