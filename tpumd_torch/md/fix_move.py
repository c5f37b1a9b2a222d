"""fix move: prescribed motion of a group of atoms (src/fix_move.cpp).

The port of tpumd/md/fix_move.py: styles linear, wiggle, rotate,
transrot and variable.  The fix integrates its group: a constrained
component takes its closed-form x(t) and v(t), a NULL one velocity-Verlet,
so the group must have no other integrator, as in the reference.  ``x0``,
the group's unwrapped positions at the fix's first set-up (FixMove's
xoriginal), rides ``MDState.peratom`` so that it follows the atoms through
every re-bin.  The time is delta = (step - time origin) dt at the step
being integrated; a new position is wrapped to the image nearest the old
one on each periodic axis (Domain::remap_near), so binning stays put while
x0 drifts anywhere.

The variable style evaluates its equal-style variables on the host for
every step of the coming segment (``segment_inputs``: the rows [dx dy dz
vx vy vz]), which reach initial_integrate as the step's input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpumd_torch.md.fix_misc import SERIALS, anchored
from tpumd_torch.md.fixes import Fix


def remap_near(xnew, xold, box):
    """xnew wrapped to the periodic image nearest xold on each periodic
    axis (Domain::remap_near)."""
    ell = box.lengths
    shift = torch.round((xnew - xold) / ell) * ell
    periodic = torch.tensor(box.periodic, device=xnew.device)
    return xnew - torch.where(periodic, shift, 0.0)


class FixMove(Fix):
    name = "move"
    needs_step = True
    xs_in_pre = True

    LINEAR, WIGGLE, ROTATE, TRANSROT, VARIABLE = range(5)

    def __init__(self, mstyle: int, *, vel=(None, None, None),
                 amp=(None, None, None), period=None, point=None,
                 axis=None, varnames=None, time_origin: int = 0):
        self.mstyle = mstyle
        self.vel = tuple(vel)
        self.amp = tuple(amp)
        self.point = None if point is None else tuple(map(float, point))
        self.runit = None
        if axis is not None:
            a = np.asarray(axis, np.float64)
            n = float(np.linalg.norm(a))
            if n == 0.0:
                raise ValueError("fix move rotate: zero-length axis")
            self.runit = tuple(a / n)
        self.omega_rotate = (None if period is None
                             else 2.0 * math.pi / float(period))
        self.varnames = varnames       # 6 names or None: dx dy dz vx vy vz
        self.time_origin = int(time_origin)
        self.script = None             # the variable style's LammpsScript
        self._serial = next(SERIALS)

    @property
    def history_key(self) -> str:
        """The key of x0 in MDState.peratom."""
        return f"fix {self.id} move {self._serial}"

    def _flags(self):
        """Which components the motion sets (the rest take the NVE kick)."""
        if self.mstyle == self.LINEAR:
            return tuple(v is not None for v in self.vel)
        if self.mstyle == self.WIGGLE:
            return tuple(a is not None for a in self.amp)
        if self.mstyle in (self.ROTATE, self.TRANSROT):
            return (True, True, True)
        return tuple(self.varnames[c] is not None
                     or self.varnames[3 + c] is not None for c in range(3))

    def init_state(self, s, ctx):
        if s.box.istriclinic:
            raise NotImplementedError("fix move on a triclinic box is not "
                                      "ported (tpumd lacks it)")
        return self.time_origin

    def set_step(self, fstate, istep):
        return istep

    def setup_post_force(self, s, fstate, ctx, xin=None):
        return anchored(s, self.history_key), fstate

    def segment_inputs(self, nsteps, ctx, s):
        """The variable style's (nsteps, 6) rows, each evaluated at its
        step's timestep (0 where a name is NULL)."""
        if self.mstyle != self.VARIABLE:
            return None
        sim = self.script.sim
        step0 = sim.step
        rows = np.zeros((nsteps, 6), np.float64)
        try:
            for k in range(nsteps):
                sim.step = step0 + k + 1
                for j, vn in enumerate(self.varnames):
                    if vn is None:
                        continue
                    v = self.script.evaluate_variable(vn)
                    if np.ndim(v) != 0:
                        raise NotImplementedError(
                            "fix move variable with an atom-style variable "
                            "is not ported (tpumd lacks it)")
                    rows[k, j] = float(v)
        finally:
            sim.step = step0
        return torch.as_tensor(rows, dtype=s.x.dtype, device=s.x.device)

    def _dtfm(self, s, ctx):
        return (0.5 * ctx.dt * ctx.units.ftm2v / ctx.mass_per_atom(s))[:, None]

    def initial_integrate(self, s, fstate, ctx, xin=None):
        dt = ctx.dt
        delta = (fstate - self.time_origin) * dt
        x0 = s.peratom[self.history_key]
        xold = s.x
        v_nve = torch.addcmul(s.v, self._dtfm(s, ctx), s.f)
        xc = list((s.x + dt * v_nve).unbind(1))
        vc = list(v_nve.unbind(1))
        flags = self._flags()
        if self.mstyle == self.LINEAR:
            for c in range(3):
                if flags[c]:
                    vc[c] = torch.full_like(vc[c], self.vel[c])
                    xc[c] = x0[:, c] + self.vel[c] * delta
        elif self.mstyle == self.WIGGLE:
            arg = self.omega_rotate * delta
            for c in range(3):
                if flags[c]:
                    vc[c] = torch.full_like(vc[c], self.amp[c]
                                            * self.omega_rotate
                                            * math.cos(arg))
                    xc[c] = x0[:, c] + self.amp[c] * math.sin(arg)
        elif self.mstyle in (self.ROTATE, self.TRANSROT):
            arg = self.omega_rotate * delta
            p = torch.tensor(self.point, dtype=s.x.dtype, device=s.x.device)
            r = torch.tensor(self.runit, dtype=s.x.dtype, device=s.x.device)
            if self.mstyle == self.TRANSROT:
                vtr = torch.tensor([v or 0.0 for v in self.vel],
                                   dtype=s.x.dtype, device=s.x.device)
                p = p + vtr * delta
            d = x0 - p
            cpar = (d @ r)[:, None] * r
            a = d - cpar
            b = torch.linalg.cross(r.expand_as(a), a)
            disp = a * math.cos(arg) + b * math.sin(arg)
            xr = p + cpar + disp
            vr = self.omega_rotate * torch.linalg.cross(r.expand_as(disp),
                                                        disp)
            if self.mstyle == self.TRANSROT:
                vr = vr + vtr
            xc, vc = list(xr.unbind(1)), list(vr.unbind(1))
        else:
            if xin is None:
                raise RuntimeError("fix move variable needs its per-step "
                                   "host inputs")
            for c in range(3):
                dn, vn = self.varnames[c], self.varnames[3 + c]
                if vn is not None:
                    vc[c] = torch.zeros_like(vc[c]) + xin[3 + c]
                    xc[c] = (x0[:, c] + xin[c] if dn is not None
                             else xold[:, c] + dt * vc[c])
                elif dn is not None:
                    # the displacement alone: x set, v kept (tpumd's rule)
                    xc[c] = x0[:, c] + xin[c]
        xnew = remap_near(torch.stack(xc, dim=1), xold, s.box)
        s = s.replace(x=self.in_group(s, xnew, s.x),
                      v=self.in_group(s, torch.stack(vc, dim=1), s.v))
        if self.mstyle in (self.ROTATE, self.TRANSROT) \
                and s.omega is not None:
            w = self.omega_rotate * torch.tensor(
                self.runit, dtype=s.x.dtype, device=s.x.device)
            s = s.replace(omega=self.in_group(s, w.expand_as(s.omega),
                                              s.omega))
        return s, fstate

    def final_integrate(self, s, fstate, ctx):
        flags = self._flags()
        if all(flags):
            return s, fstate
        vk = torch.addcmul(s.v, self._dtfm(s, ctx), s.f)
        keep = torch.tensor(flags, device=s.x.device)
        return s.replace(v=self.in_group(s, torch.where(keep, s.v, vk),
                                         s.v)), fstate
