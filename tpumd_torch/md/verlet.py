"""The velocity-Verlet timestep loop (Verlet::run, src/verlet.cpp:229-360).

PyTorch counterpart of tpumd/md/verlet.py for the cell-grid path: the
step (integrate, reneighbor decision, force evaluation, integrate) runs as
a Python loop of eager tensor operations.  The rebuild decision is made on
the host from the every/delay schedule, so a step with ``check no`` never
waits for the device; ``check yes`` reads one flag from the device on
scheduled steps (every step of the chain deck's ``every 1 delay 1``).
Energy and virial are evaluated only on output steps.  Fix states (an
RNG state) and per-step host inputs (exact RanMars draws) are threaded
through the step to the fixes' ``post_force``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
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
    # 2-body bond style evaluated inside the pair kernel by tag matching;
    # a bonded pair takes only the bond force (special_bonds fene)
    kernel_bond: Any = None
    # tags in the reference's row order (setup-sorted): host RNG streams
    # draw in this order
    ref_order_tags: np.ndarray | None = None

    def mass_per_atom(self, s: MDState):
        # index_select takes the int32 types as they are (no index copy)
        return torch.index_select(self.mass_table, 0, s.type)


def compute_forces(s: MDState, neigh: cg.CellGridState, ctx: StepContext,
                   eflag: bool, vflag: bool):
    """Pair and kernel-bond forces; returns (f, energies dict, virial (6,)
    or None).  The energies (evdwl, ebond) are None unless eflag."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=s.x.dtype, device=s.x.device)
    if ctx.pair is None:
        e = zeros() if eflag else None
        return (torch.zeros_like(s.x), {"evdwl": e, "ebond": e},
                zeros(6) if vflag else None)
    bond = None
    if ctx.kernel_bond is not None:
        bond = (s.bond_tags, s.bond_btypes, ctx.kernel_bond, s.tag)
    f, evdwl, virial, ebond = ctx.pair.compute_cellgrid(
        s.x, neigh.valid, s.box, ctx.neigh_cfg, eflag, vflag, bond=bond)
    if eflag and ebond is None:
        ebond = zeros()
    return f, {"evdwl": evdwl, "ebond": ebond}, virial


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


def step(s: MDState, neigh: cg.CellGridState, fstates, ctx: StepContext,
         xs):
    """One velocity-Verlet step; xs holds each fix's input of this step
    (or None)."""
    for fx in ctx.fixes:
        s = fx.initial_integrate(s, ctx)
    neigh = neigh.replace(ago=neigh.ago + 1)
    if decide_rebuild(s, neigh, ctx):
        s, neigh = _rebuild(s, neigh, ctx)
    f, _, _ = compute_forces(s, neigh, ctx, eflag=False, vflag=False)
    s = s.replace(f=f)
    fstates = list(fstates)
    for i, fx in enumerate(ctx.fixes):
        s, fstates[i] = fx.post_force(s, fstates[i], ctx, xs[i])
    for fx in ctx.fixes:
        s = fx.final_integrate(s, ctx)
    return s, neigh, tuple(fstates)


def run_segment(s: MDState, neigh: cg.CellGridState, fstates,
                ctx: StepContext, nsteps: int, xs=None):
    """nsteps steps; xs: per fix, None or its inputs stacked over the
    segment's steps."""
    if xs is None:
        xs = (None,) * len(ctx.fixes)
    for k in range(nsteps):
        s, neigh, fstates = step(s, neigh, fstates, ctx,
                                 [None if x is None else x[k] for x in xs])
    return s, neigh, fstates


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
