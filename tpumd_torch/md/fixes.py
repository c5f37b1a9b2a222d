"""Fixes: per-timestep state transforms around the force stage.

The reference's Fix hook pipeline (src/fix.h, dispatched per phase by
Modify) as transforms invoked at fixed phases of the step
(tpumd/md/fixes.py):

    initial_integrate -> post_integrate -> (reneighbor?) -> force eval
    -> post_force -> final_integrate -> end_of_step

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
    # whether it moves the box at end_of_step, after the force evaluation
    # whose energies thermo reports: the run splits a segment's last step
    # there (tpumd/md/simulation.py:901-915)
    eos_box_change = False
    # whether initial_integrate takes the step's input xs[i] (fix move's
    # variable style), as post_force does
    xs_in_pre = False
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

    def end_of_step(self, s, fstate, ctx):
        return s, fstate

    def virial_contrib(self, fstate):
        """The virial this fix adds (contributes_virial): its state."""
        return fstate

    def in_group(self, s, new, old):
        """new where the atom is in this fix's group, else old (new as it
        is on group all)."""
        if self.groupbit == 1:
            return new
        return torch.where(self.group_sel(s)[:, None], new, old)


def fix_state(sim, fx):
    """The run's current state of fix fx: its entry of the carry, or,
    between a host edit and the next set-up, the one kept for it."""
    if sim._carry is not None:
        for f, fs in zip(sim._ctx.fixes, sim._carry[2]):
            if f is fx:
                return fs
    return sim._fstate_stash.get(id(fx))


class FixNVE(Fix):
    """Velocity-Verlet kick-drift / kick (src/fix_nve.cpp:64-143) on the
    fix's group."""

    name = "nve"

    @staticmethod
    def _dtfm(ctx, s):
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        return (dtf / ctx.mass_per_atom(s))[:, None]

    def initial_integrate(self, s, fstate, ctx):
        v = torch.addcmul(s.v, self._dtfm(ctx, s), s.f)
        x = s.x + ctx.dt * v
        return s.replace(x=self.in_group(s, x, s.x),
                         v=self.in_group(s, v, s.v)), fstate

    def final_integrate(self, s, fstate, ctx):
        v = torch.addcmul(s.v, self._dtfm(ctx, s), s.f)
        return s.replace(v=self.in_group(s, v, s.v)), fstate


class FixNVELimit(FixNVE):
    """fix nve/limit xmax (src/fix_nve_limit.cpp; tpumd/md/fixes.py:
    126-152): velocity-Verlet with each atom's speed clamped so that it
    moves at most xmax a step, on the fix's group (tpumd's acts on every
    atom whatever its group)."""

    name = "nve/limit"

    def __init__(self, xlimit):
        self.xlimit = float(xlimit)

    def _kick(self, s, ctx):
        v = torch.addcmul(s.v, self._dtfm(ctx, s), s.f)
        vlimsq = (self.xlimit / ctx.dt) ** 2
        vsq = torch.sum(v * v, dim=1, keepdim=True)
        scale = torch.where(vsq > vlimsq, torch.sqrt(
            vlimsq / torch.clamp(vsq, min=1e-300)), 1.0)
        return v * scale

    def initial_integrate(self, s, fstate, ctx):
        v = self._kick(s, ctx)
        return s.replace(x=self.in_group(s, s.x + ctx.dt * v, s.x),
                         v=self.in_group(s, v, s.v)), fstate

    def final_integrate(self, s, fstate, ctx):
        return s.replace(v=self.in_group(s, self._kick(s, ctx), s.v)), fstate


class FixNVENoforce(Fix):
    """fix nve/noforce (src/fix_nve_noforce.cpp; tpumd/md/fixes.py:
    155-165): positions advance with the velocities, which never change;
    on the fix's group (tpumd's acts on every atom)."""

    name = "nve/noforce"

    def initial_integrate(self, s, fstate, ctx):
        return s.replace(x=self.in_group(s, s.x + ctx.dt * s.v, s.x)), fstate


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
        from tpumd_torch.ops.cellgrid import row2slot_from_tags
        breakable = [(st, t) for st, t in ctx.bonded if st.breakable]
        if breakable:
            # the grid's tuples take its slots (int64 index_select)
            rows = (row2slot_from_tags(s.tag, ctx.natoms) if ctx.is_cellgrid
                    else None)
            _, view, take = tag_view(s, ctx, rows)
            for style, tuples in breakable:
                _, xs = members(style, view, tuples, take)
                style.break_bonds(xs, tuples[:, 0], s.box)
        return s, fstate
