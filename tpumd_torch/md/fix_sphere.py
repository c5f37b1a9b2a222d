"""Granular and finite-size fixes: nve/sphere, freeze, gravity.

The port's copy of tpumd/md/fix_sphere.py: fix nve/sphere
(src/fix_nve_sphere.cpp: velocity Verlet plus the angular velocity of a
solid sphere, inertia 2/5 m r^2), fix freeze (src/GRANULAR/fix_freeze.cpp:
zero force and torque on the group) and fix gravity
(src/fix_gravity.cpp: a constant acceleration in the chute, spherical or
vector style), each on its group.
"""

from __future__ import annotations

import math

import torch

from tpumd_torch.md.fixes import Fix

_INERTIA = 0.4  # moment-of-inertia prefactor of a solid sphere


class FixNVESphere(Fix):
    """NVE with angular-velocity integration (src/fix_nve_sphere.cpp)."""

    name = "nve/sphere"

    def _kick(self, s, ctx):
        """(N, 1) factors dt / 2m of the force and dt / 2I of the torque,
        I = 2/5 m r^2 (radius 1 in empty slots)."""
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        m = ctx.mass_per_atom(s)
        rad = torch.where(s.radius > 0, s.radius, 1.0)
        return ((dtf / m)[:, None],
                (dtf / _INERTIA / (rad * rad * m))[:, None])

    def initial_integrate(self, s, fstate, ctx):
        dtfm, dtirotate = self._kick(s, ctx)
        v = s.v + dtfm * s.f
        x = s.x + ctx.dt * v
        omega = s.omega + dtirotate * s.torque
        sel = self.group_sel(s)[:, None]
        return s.replace(x=torch.where(sel, x, s.x),
                         v=torch.where(sel, v, s.v),
                         omega=torch.where(sel, omega, s.omega)), fstate

    def final_integrate(self, s, fstate, ctx):
        dtfm, dtirotate = self._kick(s, ctx)
        v = s.v + dtfm * s.f
        omega = s.omega + dtirotate * s.torque
        sel = self.group_sel(s)[:, None]
        return s.replace(v=torch.where(sel, v, s.v),
                         omega=torch.where(sel, omega, s.omega)), fstate


class FixFreeze(Fix):
    """Zero force and torque on the group every step
    (src/GRANULAR/fix_freeze.cpp post_force); the granular pair style
    reads the group bit for its effective-mass rule."""

    name = "freeze"

    def post_force(self, s, fstate, ctx, xin=None):
        sel = self.group_sel(s)[:, None]
        s = s.replace(f=torch.where(sel, 0.0, s.f))
        if s.torque is not None:
            s = s.replace(torque=torch.where(sel, 0.0, s.torque))
        return s, fstate


class FixGravity(Fix):
    """Constant gravity acceleration (src/fix_gravity.cpp)."""

    name = "gravity"

    def __init__(self, magnitude, style, *args):
        self.magnitude = float(magnitude)
        deg2rad = math.pi / 180.0
        if style == "chute" and len(args) == 1:
            theta = (180.0 - float(args[0])) * deg2rad
            acc = (math.sin(theta), 0.0, math.cos(theta))
        elif style == "spherical" and len(args) == 2:
            phi = float(args[0]) * deg2rad
            theta = float(args[1]) * deg2rad
            acc = (math.sin(theta) * math.cos(phi),
                   math.sin(theta) * math.sin(phi), math.cos(theta))
        elif style == "vector" and len(args) == 3:
            x, y, z = (float(a) for a in args)
            ln = math.sqrt(x * x + y * y + z * z)
            acc = (x / ln, y / ln, z / ln)
        else:
            raise NotImplementedError(
                f"fix gravity {style} {' '.join(args)} is not ported "
                "(chute angle, spherical phi theta, vector x y z)")
        self.acc = tuple(self.magnitude * a for a in acc)
        self._acc_dev = {}

    def post_force(self, s, fstate, ctx, xin=None):
        key = (s.x.device, s.x.dtype)
        acc = self._acc_dev.get(key)
        if acc is None:   # made once: a host copy every step would sync
            acc = self._acc_dev[key] = torch.tensor(
                self.acc, dtype=s.x.dtype, device=s.x.device)
        m = ctx.mass_per_atom(s)
        sel = self.group_sel(s)
        return s.replace(f=s.f + (m * sel)[:, None] * acc[None, :]), fstate
