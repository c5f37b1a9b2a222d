"""The velocity-Verlet timestep loop (Verlet::run, src/verlet.cpp:229-360).

PyTorch counterpart of tpumd/md/verlet.py for the cell-grid path: the
step (integrate, reneighbor decision, force evaluation, integrate) runs as
a Python loop of eager tensor operations.  The rebuild decision is made on
the host from the every/delay schedule, so a step with ``check no`` never
waits for the device; ``check yes`` reads one flag from the device on
scheduled steps.  Energy and virial are evaluated only on output steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from tpumd_torch.core.state import MDState, wrap_pbc
from tpumd_torch.md import computes
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.utils.units import Units


@dataclasses.dataclass(frozen=True, eq=False)
class StepContext:
    """Static bundle the step reads."""

    units: Units
    dt: float
    neigh_cfg: cg.CellGridConfig
    pair: Any                      # PairStyle or None
    fixes: Sequence[Any]
    mass_table: torch.Tensor       # (ntypes+1,) on the device
    natoms: int = 0                # true atom count (excludes padding)

    def mass_per_atom(self, s: MDState):
        # index_select takes the int32 types as they are (no index copy)
        return torch.index_select(self.mass_table, 0, s.type)


def compute_forces(s: MDState, neigh: cg.CellGridState, ctx: StepContext,
                   eflag: bool, vflag: bool):
    """Pair forces; returns (f, energies dict, virial (6,) or None).
    The energies are None unless eflag."""
    if ctx.pair is None:
        def zeros(*shape):
            return torch.zeros(shape, dtype=s.x.dtype, device=s.x.device)
        return (torch.zeros_like(s.x), {"evdwl": zeros() if eflag else None},
                zeros(6) if vflag else None)
    f, evdwl, virial = ctx.pair.compute_cellgrid(
        s.x, neigh.valid, s.box, ctx.neigh_cfg, eflag, vflag)
    return f, {"evdwl": evdwl}, virial


def _rebuild(s: MDState, neigh: cg.CellGridState, ctx: StepContext):
    """Wrap, re-bin and permute the state into the new slot order."""
    s = wrap_pbc(s)
    cfg = ctx.neigh_cfg
    src, dst, row2slot, max_count, over = cg.bin_compact(
        s.x, s.tag, ctx.natoms, s.box, cfg, row2slot=neigh.row2slot)
    s = cg.apply_permutation_compact(s, src, dst, cfg.capacity)
    # placed atoms carry their tag; empty and dropped slots were zeroed
    neigh = cg.CellGridState(
        valid=s.tag > 0, xhold=s.x, ago=0, nbuilds=neigh.nbuilds + 1,
        overflow=neigh.overflow | over, max_count=max_count,
        row2slot=row2slot)
    return s, neigh


def decide_rebuild(s: MDState, neigh: cg.CellGridState,
                   ctx: StepContext) -> bool:
    """Neighbor::decide (src/neighbor.cpp:2293): ago-based schedule, then
    the half-skin displacement check when ``check yes``."""
    cfg = ctx.neigh_cfg
    if not (neigh.ago >= cfg.delay and neigh.ago % cfg.every == 0):
        return False
    if cfg.check:
        return bool(cg.displacement_exceeded(
            s.x, neigh.xhold, neigh.valid, s.box, cfg.skin))
    return True


def step(s: MDState, neigh: cg.CellGridState, ctx: StepContext):
    """One velocity-Verlet step."""
    for fx in ctx.fixes:
        s = fx.initial_integrate(s, ctx)
    neigh = neigh.replace(ago=neigh.ago + 1)
    if decide_rebuild(s, neigh, ctx):
        s, neigh = _rebuild(s, neigh, ctx)
    f, _, _ = compute_forces(s, neigh, ctx, eflag=False, vflag=False)
    s = s.replace(f=f)
    for fx in ctx.fixes:
        s = fx.final_integrate(s, ctx)
    return s, neigh


def run_segment(s: MDState, neigh: cg.CellGridState, ctx: StepContext,
                nsteps: int):
    for _ in range(nsteps):
        s, neigh = step(s, neigh, ctx)
    return s, neigh


def eval_energies(s: MDState, neigh: cg.CellGridState, ctx: StepContext):
    """Force + energy + virial evaluation for thermo output steps."""
    return compute_forces(s, neigh, ctx, eflag=True, vflag=True)


def pack_thermo(s: MDState, energies, virial, scal, mass_table):
    """Thermo vector on the device, fetched with one transfer.

    Layout: [temp, vol, sum(vir[:3]), natoms, lengths(3), energies in
    sorted-key order].  scal = (dof, boltz, mvv2e)."""
    dof, boltz, mvv2e = scal
    mass = torch.index_select(mass_table, 0, s.type)
    t_dev = computes.temperature(s.v, mass, dof, boltz, mvv2e)
    dt_ = s.x.dtype
    ell = s.box.lengths
    return torch.cat([
        torch.stack([t_dev, s.box.volume, torch.sum(virial[:3]),
                     torch.sum(s.tag > 0).to(dt_)]),
        ell, torch.stack([energies[k] for k in sorted(energies)])])
