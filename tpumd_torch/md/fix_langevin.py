"""fix langevin: Langevin thermostat.

Physics per the reference (src/fix_langevin.cpp:286-297 gfactors,
:640-680 post_force), as tpumd/md/fix_langevin.py has it:
f += gamma1*v + gamma2*(u-0.5) with gamma1 = -m/(damp*ftm2v) and
gamma2 = sqrt(m)/ftm2v * sqrt(24*kB*T_target/(damp*dt*mvv2e)).

Two RNG modes:
- "lammps": bit-exact RanMars draws made on the host per segment, nsteps
  * natoms * 3 of them, in the reference's row order (the setup-sorted
  order) and re-indexed by tag, so that each kick reaches the same atom
  whatever the grid's slot order.  Equal to tpumd's "lammps" mode.
- "device": ``torch.rand`` from an explicit ``torch.Generator`` on the
  run's device, seeded from the fix's seed: a (natoms, 3) block a step,
  row tag - 1 for the atom of that tag.  Not the reference's stream.
"auto" picks "lammps" on the CPU and "device" on CUDA; host draws at
~1e5 per step would bound a step on the card.

Either way a kick reaches its atom by tag, so a run decomposed over ranks
(each rank drawing the whole block from the same seed and keeping its
slots' rows, halo copies included) gives the kicks of one card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpumd_torch.md.fixes import Fix
from tpumd_torch.utils.ranmars import RanMars


class FixLangevin(Fix):
    name = "langevin"

    def __init__(self, t_start, t_stop, damp, seed, *, device, rng="auto"):
        self.t_start = float(t_start)
        self.t_stop = float(t_stop)
        self.damp = float(damp)
        self.seed = int(seed)
        if rng == "auto":
            rng = "lammps" if torch.device(device).type == "cpu" else "device"
        if rng not in ("lammps", "device"):
            raise ValueError(f"fix langevin: unknown rng mode {rng!r}")
        self.rng = rng
        self._stream = RanMars(self.seed)
        self._gen = None

    def init_state(self, s, ctx):
        """The "device" mode's generator state (seed and offset)."""
        if self.rng != "device":
            return None
        g = torch.Generator(device=s.x.device)
        g.manual_seed(self.seed)
        return g.get_state()

    def segment_inputs(self, nsteps, ctx, s):
        if self.rng != "lammps":
            return None
        n = ctx.natoms
        arr = self._stream.fill(nsteps * n * 3).reshape(nsteps, n, 3)
        tags = ctx.ref_order_tags
        if tags is not None:
            out = np.empty_like(arr)
            out[:, tags - 1, :] = arr
            arr = out
        return torch.as_tensor(arr, dtype=s.x.dtype, device=s.x.device)

    def post_force(self, s, fstate, ctx, xin=None):
        u = ctx.units
        m = ctx.mass_per_atom(s)
        # constant-T decks; a ramp would interpolate on the step
        t_target = self.t_start
        gamma1 = -m / self.damp / u.ftm2v
        gamma2 = (torch.sqrt(m) / u.ftm2v
                  * math.sqrt(24.0 * u.boltz / (self.damp * ctx.dt
                                                * u.mvv2e))
                  * math.sqrt(t_target))
        if self.rng == "device":
            if self._gen is None or self._gen.device != s.x.device:
                self._gen = torch.Generator(device=s.x.device)
            self._gen.set_state(fstate)
            xin = torch.rand((ctx.natoms, 3), generator=self._gen,
                             dtype=s.x.dtype, device=s.x.device)
            fstate = self._gen.get_state()
        # tag-indexed draws -> this slot's atom (padded slots read row 0
        # and are masked below)
        rand = torch.index_select(xin, 0,
                                  torch.clamp(s.tag - 1, min=0)) - 0.5
        fran = gamma2[:, None] * rand
        fdrag = gamma1[:, None] * s.v
        valid = self.group_sel(s)[:, None]
        return s.replace(f=s.f + torch.where(valid, fdrag + fran, 0)), fstate
