"""Fixes: per-timestep state transforms around the force stage.

The reference's Fix hook pipeline (src/fix.h, dispatched per phase by
Modify) as transforms invoked at fixed phases of the step
(tpumd/md/fixes.py):

    initial_integrate -> post_integrate -> (reneighbor?) -> force eval
    -> post_force -> final_integrate

A fix object is a host-side config.  A fix that carries data from step
to step (an RNG state, thermostat chains, a constraint virial) keeps it in
a per-fix state value that the run loop threads through every hook, so a
segment redone after a cell overflow replays from its snapshot.

Optional protocol (tpumd/md/fixes.py): ``setup_post_force`` replaces
post_force at set-up; ``needs_virial`` fixes get the step's total virial
through ``save_virial`` after post_force; ``contributes_virial`` fixes add
``virial_contrib(fstate)`` to it; ``needs_step`` fixes get the timestep
through ``set_step``, and ``pre_run`` gets a run's first and last steps.
A fix acts on the atoms of its group (``groupbit``, 1 for group all).
"""

from __future__ import annotations

import torch


class Fix:
    dof_removed = 0          # dof this fix removes from the group
    needs_virial = False
    contributes_virial = False
    needs_step = False
    groupbit = 1             # group membership bit (1: group all)
    # whether the fix moves the box between rebuilds (Fix::box_change,
    # src/fix.h): the rebuild check of a carried pair list then counts
    # the box's move
    box_change = False
    # a fix that acts on the host every host_every steps (0: never): the
    # run loop ends a segment there and calls host_end_of_step(sim)
    host_every = 0

    def group_sel(self, s):
        """(N,) bool mask of the atoms this fix acts on."""
        if self.groupbit == 1:
            return s.type > 0
        return (s.gmask & self.groupbit) > 0

    def init_state(self, s, ctx):
        """Per-fix state at setup."""
        return None

    def segment_inputs(self, nsteps: int, ctx, s):
        """Optional host-generated per-step inputs, stacked over nsteps."""
        return None

    def initial_integrate(self, s, fstate, ctx):
        return s, fstate

    def post_integrate(self, s, fstate, ctx):
        return s, fstate

    def post_force(self, s, fstate, ctx, xin=None):
        return s, fstate

    def setup_post_force(self, s, fstate, ctx, xin=None):
        return self.post_force(s, fstate, ctx, xin)

    def final_integrate(self, s, fstate, ctx):
        return s, fstate

    def virial_contrib(self, fstate):
        """The virial this fix adds (contributes_virial): its state."""
        return fstate


class FixNVE(Fix):
    """Velocity-Verlet kick-drift / kick (src/fix_nve.cpp:64-143), on
    group all only."""

    name = "nve"

    @staticmethod
    def _dtfm(ctx, s):
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        return (dtf / ctx.mass_per_atom(s))[:, None]

    def initial_integrate(self, s, fstate, ctx):
        v = torch.addcmul(s.v, self._dtfm(ctx, s), s.f)
        return s.replace(x=s.x + ctx.dt * v, v=v), fstate

    def final_integrate(self, s, fstate, ctx):
        return (s.replace(v=torch.addcmul(s.v, self._dtfm(ctx, s), s.f)),
                fstate)


class FixBondBreak(Fix):
    """Built-in companion of a breakable bond style (bond_style quartic),
    which the set-up adds where one has bonds (tpumd/md/simulation.py:
    519-540): after the position update and before the force evaluation,
    clear the carried alive flag of every bond stretched past Rc, the step
    at which the reference clears bondlist[n][2] inside its force loop
    (src/MOLECULE/bond_quartic.cpp:85-95; tpumd/md/fixes.py:60-86).  The
    flags only ever go from alive to broken."""

    name = "bond_break"
    id = "bond_break"

    def post_integrate(self, s, fstate, ctx):
        from tpumd_torch.models.bonded import members, tag_view
        breakable = [(st, t) for st, t in ctx.bonded if st.breakable]
        if breakable:
            _, view, take = tag_view(s, ctx)
            for style, tuples in breakable:
                _, xs = members(style, view, tuples, take)
                style.break_bonds(xs, tuples[:, 0], s.box)
        return s, fstate
