"""Fixes: per-timestep state transforms around the force stage.

The reference's Fix hook pipeline (src/fix.h, dispatched per phase by
Modify) as ``(state, ctx) -> state`` transforms invoked at fixed phases
of the step (tpumd/md/fixes.py):

    initial_integrate -> (reneighbor?) -> force eval -> final_integrate
"""

from __future__ import annotations

import torch


class Fix:
    dof_removed = 0          # dof this fix removes from the group

    def initial_integrate(self, s, ctx):
        return s

    def final_integrate(self, s, ctx):
        return s


class FixNVE(Fix):
    """Velocity-Verlet kick-drift / kick (src/fix_nve.cpp:64-143)."""

    @staticmethod
    def _dtfm(ctx, s):
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        return (dtf / ctx.mass_per_atom(s))[:, None]

    def initial_integrate(self, s, ctx):
        v = torch.addcmul(s.v, self._dtfm(ctx, s), s.f)
        return s.replace(x=s.x + ctx.dt * v, v=v)

    def final_integrate(self, s, ctx):
        return s.replace(v=torch.addcmul(s.v, self._dtfm(ctx, s), s.f))
