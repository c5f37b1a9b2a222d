"""The velocity-Verlet timestep loop (Verlet::run, src/verlet.cpp:229-360).

PyTorch counterpart of tpumd/md/verlet.py, on the cell grid or the matrix
neighbor engine (``StepContext.is_cellgrid``): the step (integrate,
reneighbor decision, force evaluation, fix hooks, integrate, end_of_step)
runs as a Python loop of eager tensor operations, in two parts
(``step_pre`` through the force evaluation, ``step_post`` after it) so
that the run can read the energies between them where a fix moves the
box at end_of_step.  The rebuild decision is made on
the host from the every/delay schedule, so a step with
``check no`` never waits for the device; ``check yes`` reads one flag from
the device on scheduled steps.  Energies are evaluated only on output
steps; the virial on every step when a fix needs it (a barostat).  Fix
states and per-step host inputs (exact RanMars draws) are threaded
through every fix hook, each hook in the fixes' deck order: so a rigid
fix's integration (with rigid/npt's box remap inside it), RATTLE's
constraint force at final_integrate and fix nh's halves interleave as
the deck lists them (tpumd/md/verlet.py:380-410).

A force evaluation sums the pair sweep (with charges and special lists
for charged styles), the bonded styles on the tag-order view of the
engine's rows (gathered through the grid's ``row2slot``, or on the matrix
engine through the rows of the tags with P1, and scattered back with one
``index_add_``) or, with ``StepContext.bonded_grid``, from each slot's
tuples matched by tag (``ops/cellgrid_tuples.py``: the path of a rank's
local grid), and kspace.  A granular style's sweep also returns
torques and, in the step (``shearupdate``), the new contact history, which
the grid state carries and every re-bin moves with the atoms; set-up and
thermo evaluations read the history without advancing it.  A rebuild
shrink-wraps the box's s/m faces to the atoms first.

Every style on the grid sweeps a pair list (lj/cut, with or without FENE
bonds in its kernel, both passes of eam, lj/charmm/coul/long,
gran/hooke/history): it gets one from every re-bin, at
set-up and at each rebuild, carried in the grid state with the bond
partners' slots; a row longer than its K raises the overflow flag as a
full cell does.  Where the schedule leaves a step's force evaluation
unchecked (check no, the steps before the delay, every > 1), the list is
refreshed on the card first wherever some atom moved more than skin/2
since its build, so the sweep sums the stencil's pairs
(``ops/cellgrid_pairlist.py``); a refresh is not a rebuild.

On the matrix engine the atoms keep their rows: a rebuild wraps,
shrink-wraps and builds the (N, K) neighbor matrix, and a granular style's
per-slot history follows each (i, j) pair into its new slot.  A box
narrower than 2 cutneigh evaluates pairs against image copies of the
atoms, rebuilt from the live positions at every evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from tpumd_torch.core.state import MDState, wrap_pbc
from tpumd_torch.md import computes
from tpumd_torch.models.bonded import compute_tuples, tag_view
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops.cellgrid_tuples import compute_bonded_grid
from tpumd_torch.ops import neighbor as nb
from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist, \
    new_stat, pairlist_hold, partner_slots, refresh_pairlist
from tpumd_torch.utils.units import Units

# the energies of a force evaluation (tpumd/md/verlet.py:123-124)
ENERGY_KEYS = ("evdwl", "ecoul", "ebond", "eangle", "edihed", "eimp",
               "elong")


@dataclasses.dataclass(frozen=True, eq=False)
class StepContext:
    """Static bundle the step reads."""

    units: Units
    dt: float
    neigh_cfg: cg.CellGridConfig | nb.NeighborConfig
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
    # bonded styles with their tuples on the device: ((style, (M, 1 +
    # arity) of type and tag-1 members, int64 on the grid, int32 on the
    # matrix engine for P1), ...)
    bonded: tuple = ()
    kspace: Any = None
    # special_bonds weights by code 0..3 (code 0: no special, weight 1)
    special_lj: tuple = (1.0, 1.0, 1.0, 1.0)
    special_coul: tuple = (1.0, 1.0, 1.0, 1.0)
    tdof: float = 0.0              # thermostat degrees of freedom
    # shrink-wrapped faces: ((dim, shrink_lo, shrink_hi, small), ...)
    # (Domain::reset_box, src/domain.cpp:431-460)
    shrink: tuple = ()
    # row width K of the cell grid's pair list (ops/cellgrid_pairlist.py);
    # 0: no list (the matrix engine, or no pair style)
    pairlist_k: int = 0
    # the neigh_modify exclude group-bit pairs the list drops
    pairlist_exclude: tuple = ()
    # the schedule leaves some steps unchecked: the list is refreshed
    # where stale (ops/cellgrid_pairlist.py::refresh_pairlist)
    pairlist_refresh: bool = False
    # run_style respa: (loop factors, the force terms of each level), the
    # outermost level last; None under verlet
    respa: tuple | None = None
    # the run decomposed over a process group (parallel/decomp.py): a
    # GridDecomp (neigh_cfg is then its local grid) or a RowDecomp; None
    # on one card
    decomp: Any = None
    # the grid's bonded styles match their members by tag from the
    # per-atom tables of MDState.peratom (ops/cellgrid_tuples.py); SHAKE's
    # clusters too
    bonded_grid: bool = False

    def mass_per_atom(self, s: MDState):
        if s.rmass is not None:
            # per-atom masses (sphere style); empty slots take mass 1
            return torch.where(s.rmass > 0, s.rmass, 1.0)
        # index_select takes the int32 types as they are (no index copy)
        return torch.index_select(self.mass_table, 0, s.type)

    @property
    def need_virial(self) -> bool:
        return any(fx.needs_virial for fx in self.fixes)

    @property
    def is_cellgrid(self) -> bool:
        return isinstance(self.neigh_cfg, cg.CellGridConfig)


def _pair_ext(s: MDState, ctx: StepContext):
    """(xj, tj, qj, vbox): the multi-image mode's copy tables and the box
    of the extended domain, from the live positions (the copies follow
    their atoms between rebuilds); None outside that mode
    (tpumd/md/verlet.py:97-108)."""
    cfg = ctx.neigh_cfg
    if ctx.is_cellgrid or not cfg.image_shifts:
        return None
    nshift = len(cfg.image_shifts)
    return (nb.ext_coords(s.x, s.box, cfg), s.type.repeat(nshift),
            None if s.q is None else s.q.repeat(nshift),
            nb.ext_box(s.box, cfg))


def _matrix_pair(s: MDState, neigh: nb.NeighborState, ctx: StepContext,
                 eflag: bool, vflag: bool, shearupdate: bool, xall=None):
    """(f, energies, virial, torque, neigh) of the pair style on the matrix
    neighbor engine (tpumd/md/verlet.py:143-147, :186-190); xall, on a
    rank's rows, every row's positions."""
    pair = ctx.pair
    if getattr(pair, "is_granular", False):
        f, torque, shear = pair.compute_gran(s, neigh.idx, neigh.shear,
                                             ctx.dt, shearupdate)
        if shearupdate:
            neigh = neigh.replace(shear=shear)
        return f, {}, None, torque, neigh
    special = ctx.neigh_cfg.has_special
    # a rank's rows take their j sides from every row's positions
    kw = ({"ext": _pair_ext(s, ctx)} if ctx.decomp is None
          else {"ext": ctx.decomp.ext(s, xall), "row0": ctx.decomp.r0})
    f, evdwl, ecoul, vir = pair.compute(
        s.x, s.type, s.box, neigh.idx, neigh.sbits,
        ctx.special_lj if special else None,
        ctx.special_coul if special else None, eflag, vflag, q=s.q, **kw)
    return f, {"evdwl": evdwl, "ecoul": ecoul}, vir, None, neigh


def grid_special(s: MDState, ctx: StepContext) -> dict:
    """{"special": the special_bonds lj weights of codes 1-3} where the
    grid's lj/cut sweep weighs the list's special pairs (the state carries
    special lists, and no FENE bond rides the kernel), else {}: keyword
    arguments of the style's compute_cellgrid."""
    if s.special_tags is None or ctx.kernel_bond is not None or not getattr(
            ctx.pair, "grid_special", False):
        return {}
    return {"special": tuple(float(w) for w in ctx.special_lj[1:])}


def compute_forces(s: MDState, neigh, ctx: StepContext, eflag: bool,
                   vflag: bool, shearupdate: bool = False, istep: int = 0,
                   cats=None):
    """All forces; returns (f, energies {ENERGY_KEYS} or None, virial (6,)
    or None, torque (N, 3) or None, neigh).  Only a granular style gives a
    torque, and with shearupdate a neigh holding the new history.  neigh
    is a cg.CellGridState or, on the matrix engine, an nb.NeighborState;
    kspace and the bonded styles run on either engine's rows (padded grid
    slots carry q = 0; the bonded styles on the tag-order view, through
    P1 on the matrix engine).  A style with a Coulomb self-energy (Wolf,
    DSF) adds the sum of its atoms' to ecoul, summed in float64.

    On the matrix engine, a style that reads velocities (DPD) takes the
    timestep istep for its random kick (0 outside the step, as in tpumd),
    and a TIP4P style's charge sites stand in for the atoms in its Coulomb
    sum and in kspace, their forces spread back onto the atoms once
    (tpumd/md/verlet.py:150-156; models/pair_tip4p.py).  Every kspace style
    takes the positions, charges and types of the rows
    (``compute(x, q, box, eflag, vflag, type_)``).

    cats, where given, names the terms to sum (run_style respa's levels):
    "pair", the bonded kinds and "kspace"."""
    energies = virial = None
    if eflag:
        energies = dict.fromkeys(ENERGY_KEYS, torch.zeros(
            (), dtype=s.x.dtype, device=s.x.device))
    if vflag:
        virial = torch.zeros(6, dtype=s.x.dtype, device=s.x.device)

    def tally(e, vir):
        nonlocal virial
        if eflag:
            for k, val in e.items():
                if val is not None:
                    energies[k] = energies[k] + val
        if vflag and vir is not None:
            virial = virial + vir

    pair = ctx.pair if cats is None or "pair" in cats else None
    torque = sites = xall = None
    rows_dec = ctx.decomp is not None and ctx.decomp.kind == "rows"
    if rows_dec:
        # a rank's rows read every row's positions: one all-gather an
        # evaluation, for the pair sweep and the bonded styles alike
        xall = ctx.decomp.gather_x(s.x)
    if pair is None:
        f = torch.zeros_like(s.x)
    elif getattr(pair, "is_tip4p", False):
        sites = pair.charge_sites(s, ctx.natoms)
        special = ctx.neigh_cfg.has_special
        f, fsite, evdwl, ecoul, vir = pair.compute_sites(
            s, neigh.idx, neigh.sbits, sites,
            ctx.special_lj if special else None,
            ctx.special_coul if special else None, eflag, vflag)
        tally({"evdwl": evdwl, "ecoul": ecoul}, vir)
    elif getattr(pair, "needs_velocities", False):
        f, evdwl, vir = pair.compute_vel(s, neigh, ctx, eflag, vflag, istep)
        tally({"evdwl": evdwl}, vir)
    elif not ctx.is_cellgrid:
        f, e, vir, torque, neigh = _matrix_pair(s, neigh, ctx, eflag,
                                                vflag, shearupdate, xall)
        tally(e, vir)
    elif getattr(pair, "is_granular", False):
        f, torque, stags, shear = pair.compute_gran_cellgrid(
            s, neigh.valid, neigh.shear_tags, neigh.shear, ctx.neigh_cfg,
            ctx.dt, shearupdate, (neigh.pairs, neigh.npairs,
                                  neigh.row2slot))
        if shearupdate:
            neigh = neigh.replace(shear_tags=stags, shear=shear)
    elif getattr(pair, "charged", False):
        # on a rank's local grid B5 sweeps the owned rows
        f, evdwl, ecoul, vir = pair.compute_cellgrid_charged(
            s, neigh, ctx.neigh_cfg, ctx.special_lj, ctx.special_coul,
            eflag, vflag, rows=None if neigh.owned is None
            else neigh.row2slot)
        tally({"evdwl": evdwl, "ecoul": ecoul}, vir)
    else:
        bond = None
        if ctx.kernel_bond is not None:
            bond = (ctx.kernel_bond, (neigh.pairs, neigh.npairs,
                                      neigh.bond_slots, neigh.row2slot))
        # on a rank's local grid the sweeps take the owned slots (the
        # halos' rows are the neighbours'), and EAM's F'(rho) of the halo
        # slots comes from their owners between its two sweeps
        kw = grid_special(s, ctx)
        if ctx.decomp is not None and getattr(pair, "forward_fp", False):
            kw["halo"] = ctx.decomp.exchange_fp
        f, evdwl, vir, ebond = pair.compute_cellgrid(
            s.x, neigh.valid if neigh.owned is None else neigh.owned, s.box,
            ctx.neigh_cfg, eflag, vflag, bond=bond,
            plist=(neigh.pairs, neigh.npairs, neigh.row2slot), **kw)
        tally({"evdwl": evdwl, "ebond": ebond}, vir)

    if eflag and s.q is not None and hasattr(pair, "ecoul_self_atom"):
        # ev_tally(i, i, ...) of each atom's self-energy (coul/dsf:37)
        energies["ecoul"] = energies["ecoul"] + torch.sum(
            pair.ecoul_self_atom(s.q.to(torch.float64))).to(s.x.dtype)

    bonded = [(st, t) for st, t in ctx.bonded
              if cats is None or st.kind in cats]
    if bonded and ctx.bonded_grid:
        # each slot's tuples with their members matched by tag
        # (ops/cellgrid_tuples.py): no gather through the global tag map,
        # so a rank's local grid runs it; a lost member is flagged
        fb, e, vir, lost = compute_bonded_grid(
            s, ctx, [st for st, _ in bonded], eflag, vflag)
        f = f + fb
        tally(e or {}, vir)
        neigh = neigh.replace(tuples_missing=lost if neigh.tuples_missing
                              is None else neigh.tuples_missing | lost)
    elif bonded:
        # the tag-order view: row tag-1 holds that atom (on a rank's rows,
        # of every row, the energies and virial counted on rank 0)
        rows, view, take = tag_view(
            s, ctx, neigh.row2slot if ctx.is_cellgrid else None, xall)
        ftag = None
        for style, tuples in bonded:
            fb, e, vir = compute_tuples(style, view, tuples, s.box, ctx,
                                        eflag, vflag, take)
            ftag = fb if ftag is None else ftag + fb
            if rows_dec:
                e = None if e is None else {
                    k: ctx.decomp.once(v) for k, v in e.items()}
                vir = None if vir is None else ctx.decomp.once(vir)
            tally(e or {}, vir)
        if rows_dec:
            f = f + torch.zeros_like(xall).index_add_(
                0, rows.long(), ftag)[ctx.decomp.r0:ctx.decomp.r1]
        else:
            f = f.index_add(0, rows, ftag)

    if ctx.kspace is not None and (cats is None or "kspace" in cats):
        q = s.q
        if ctx.decomp is not None and ctx.is_cellgrid:
            # the mesh takes each atom's charge once: from its owner
            q = torch.where(neigh.owned, q, 0.0)
        fk, elong, vir = ctx.kspace.compute(
            s.x if sites is None else sites.xq, q, s.box, eflag, vflag,
            type_=s.type)
        if sites is None:
            f = f + fk
        else:
            fsite = fsite + fk
        tally({"elong": elong}, vir)
    if sites is not None:
        f = f + sites.distribute(fsite)
    return f, energies, virial, torque, neigh


def reset_box_shrink(s: MDState, ctx: StepContext) -> MDState:
    """Shrink-wrap the box's s/m faces to the atoms' extent plus ``small``
    (Domain::reset_box, src/domain.cpp:431-460; tpumd/md/verlet.py::
    reset_box_shrink), on the device; empty slots do not count."""
    if not ctx.shrink:
        return s
    lo, hi = s.box.lo.clone(), s.box.hi.clone()
    valid = s.tag > 0
    for dim, shrink_lo, shrink_hi, small in ctx.shrink:
        xs = s.x[:, dim]
        if shrink_hi:
            hi[dim] = torch.max(torch.where(valid, xs, -torch.inf)) + small
        if shrink_lo:
            lo[dim] = torch.min(torch.where(valid, xs, torch.inf)) - small
    return s.replace(box=s.box.replace(lo=lo, hi=hi))


def partner_tags(tag, idx):
    """(N, K) the tags of each row's neighbors in the (N, K) matrix idx,
    0 in the self-index padding."""
    own = torch.arange(idx.shape[0], dtype=idx.dtype,
                       device=idx.device)[:, None]
    return torch.where(idx != own, tag[idx], 0)


def remap_history_by_tag(old_tags, old_shear, new_tags):
    """Carry per-slot history to a new list: each new slot takes the
    history of the old slot of its row that held the same partner tag, or
    0 (FixNeighHistory, src/fix_neigh_history.cpp; tpumd/md/verlet.py:
    301-320).  A partner appears at most once in a row, so the batched
    product of the 0/1 match with the old history copies it exactly."""
    match = ((new_tags[:, :, None] == old_tags[:, None, :])
             & (old_tags > 0)[:, None, :]).to(old_shear.dtype)
    out = torch.bmm(match, old_shear)                  # (N, Knew, 3)
    return torch.where((new_tags > 0)[..., None], out, 0.0)


def _remap_shear(old_idx, new_idx, shear):
    """remap_history_by_tag on row indices: each new slot (i, j) takes the
    history of the old slot of row i that held the same j, or 0."""
    rows = torch.arange(1, old_idx.shape[0] + 1, dtype=old_idx.dtype,
                        device=old_idx.device)
    return remap_history_by_tag(partner_tags(rows, old_idx), shear,
                                partner_tags(rows, new_idx))


def build_matrix(s: MDState, ctx: StepContext, nbuilds: int,
                 old: nb.NeighborState | None = None, history=False):
    """A neighbor state for the wrapped state s on the matrix engine: the
    list, and with ``history`` a granular style's (N, K, 3) history,
    carried over from ``old`` by j-match or zero."""
    gmask = s.gmask
    if gmask is None and ctx.neigh_cfg.exclude_bits:
        # no group command yet: every atom is in group all (bit 1)
        gmask = torch.ones_like(s.tag)
    x, rows, tag = s.x, None, s.tag
    if ctx.decomp is not None:
        # a rank builds its rows over every row's positions, their special
        # partners found among every row's tags
        x, rows = ctx.decomp.gather_x(s.x), (ctx.decomp.r0, ctx.decomp.r1)
        tag = ctx.decomp.tag_all
    idx, sbits, max_count, over = nb.build_neighbors(
        x, s.box, ctx.neigh_cfg, special_tags=s.special_tags,
        special_codes=s.special_codes, tag=tag, gmask=gmask, rows=rows)
    shear = None
    if history:
        shear = (_remap_shear(old.idx, idx, old.shear) if old is not None
                 else torch.zeros(idx.shape + (3,), dtype=s.x.dtype,
                                  device=s.x.device))
    return nb.NeighborState(idx=idx, sbits=sbits, xhold=s.x, ago=0,
                            nbuilds=nbuilds, overflow=over,
                            max_count=max_count, shear=shear)


def grid_pairlist(s: MDState, valid, ctx: StepContext, stat=None):
    """The pair list fields of a freshly binned grid state (empty without
    ctx.pairlist_k), with the box corners of the build where a fix moves
    the box between rebuilds (a barostat; a shrink-wrapped face moves
    only at a rebuild, as LAMMPS resets the box), and its overflow
    flag (None without a list).  stat, the (4,) status words the state
    keeps over its re-bins (fresh ones by default), takes the build's
    longest row and overflow.  With FENE bonds in the pair kernel the bond
    partners are the special list, at code 1 (special_bonds fene), and
    their slots ride the state; the exclusions of ctx.pairlist_exclude
    read the group bits (every atom in group all without a group
    command).  Under ctx.pairlist_refresh the list keeps its ListHold."""
    if ctx.pairlist_k == 0:
        return {}, None
    stags, scodes = s.special_tags, s.special_codes
    fields = {}
    if ctx.kernel_bond is not None:
        stags, scodes = s.bond_tags, torch.ones_like(s.bond_tags)
        fields["bond_slots"] = partner_slots(s.tag, s.bond_tags, s.x)
    gmask = s.gmask
    if gmask is None and ctx.pairlist_exclude:
        gmask = torch.ones_like(s.tag)
    if stat is None:
        stat = new_stat(s.x.device)
    box_change = any(fx.box_change for fx in ctx.fixes)
    hold = None
    if ctx.pairlist_refresh:
        hold = fields["list_hold"] = pairlist_hold(
            s.x, valid, s.tag, stags, scodes, ctx.neigh_cfg, gmask,
            ctx.pairlist_exclude, box_term=box_change)
    pairs, npairs, longest, over = cellgrid_pairlist(
        s.x, valid, s.tag, stags, scodes, list_box(s, ctx), ctx.neigh_cfg,
        ctx.pairlist_k, gmask, ctx.pairlist_exclude, stat=stat, hold=hold)
    if box_change:
        fields.update(lohold=s.box.lo, hihold=s.box.hi)
    return {"pairs": pairs, "npairs": npairs, "list_stat": stat,
            "max_pairs": longest, **fields}, over


def list_box(s: MDState, ctx: StepContext):
    """The box of the grid's list build and refresh: on a rank's local grid
    the split axes are not periodic (their halos carry the seam shift)."""
    return s.box if ctx.decomp is None else ctx.decomp.list_box(s.box)


def _rebuild(s: MDState, neigh, ctx: StepContext):
    """Wrap and shrink-wrap; then on the cell grid re-bin and permute the
    state (and a granular style's history tables) into the new slot order,
    on the matrix engine rebuild the list in place (tpumd/md/verlet.py:
    372-388).  On a rank's local grid the re-bin migrates the owned atoms
    whose cell left the block, bins them and refills the halo slots
    (``GridDecomp.rebin``)."""
    s = reset_box_shrink(wrap_pbc(s), ctx)
    if not ctx.is_cellgrid:
        new = build_matrix(s, ctx, neigh.nbuilds + 1, old=neigh,
                           history=neigh.shear is not None)
        return s, new.replace(overflow=neigh.overflow | new.overflow)
    if ctx.decomp is not None:
        s, valid, owned, rows, max_count, over = ctx.decomp.rebin(
            s, neigh.row2slot)
        plist, list_over = grid_pairlist(s, valid, ctx, neigh.list_stat)
        if list_over is not None:
            over = over | list_over
        return s, cg.CellGridState(
            valid=valid, xhold=s.x, ago=0, nbuilds=neigh.nbuilds + 1,
            overflow=neigh.overflow | over, max_count=max_count,
            row2slot=rows, owned=owned, tuples_missing=neigh.tuples_missing,
            **plist)
    cfg = ctx.neigh_cfg
    src, dst, row2slot, max_count, over = cg.bin_compact(
        s.x, s.tag, ctx.natoms, s.box, cfg, row2slot=neigh.row2slot)
    s = cg.apply_permutation_compact(s, src, dst, cfg.capacity)
    history = {}
    if neigh.shear is not None:
        history = {k: cg.move_rows(getattr(neigh, k), src, dst, cfg.capacity)
                   for k in ("shear_tags", "shear")}
    # placed atoms carry their tag; empty and dropped slots were zeroed
    valid = s.tag > 0
    plist, list_over = grid_pairlist(s, valid, ctx, neigh.list_stat)
    if list_over is not None:
        over = over | list_over
    neigh = cg.CellGridState(
        valid=valid, xhold=s.x, ago=0, nbuilds=neigh.nbuilds + 1,
        overflow=neigh.overflow | over, max_count=max_count,
        row2slot=row2slot, tuples_missing=neigh.tuples_missing, **history,
        **plist)
    return s, neigh


def rebuild_now(s: MDState, neigh, ctx: StepContext):
    """A rebuild outside the step (a host edit of the special lists during
    a run): (s, neigh)."""
    return _rebuild(s, neigh, ctx)


def decide_rebuild(s: MDState, neigh, ctx: StepContext) -> bool:
    """Neighbor::decide (src/neighbor.cpp:2293): ago-based schedule, then
    the half-skin displacement check when ``check yes``
    (tpumd/md/verlet.py:390-410), less the box's move since the build on a
    grid that carries a pair list under a fix that moves the box."""
    cfg = ctx.neigh_cfg
    if not (neigh.ago >= cfg.delay and neigh.ago % cfg.every == 0):
        return False
    if not cfg.check:
        return True
    if ctx.is_cellgrid:
        moved = cg.displacement_exceeded(
            s.x, neigh.xhold, neigh.valid if neigh.owned is None
            else neigh.owned, s.box, cfg.skin, neigh.lohold, neigh.hihold)
    else:
        moved = nb.displacement_exceeded(s.x, neigh.xhold, s.box, cfg.skin)
    if ctx.decomp is not None:
        # every rank checks its own atoms and takes the same decision
        return bool(ctx.decomp.mesh.agree_max(moved))
    return bool(moved)


def refresh_list(s: MDState, neigh, ctx: StepContext):
    """Keep the pair list complete at a step that did not re-bin: unless
    the schedule's displacement check ran this step against the list's own
    positions (no refresh since the re-bin), refresh it where some atom
    moved more than skin/2 since its build (the decision on the device)."""
    cfg = ctx.neigh_cfg
    checked = (cfg.check and neigh.ago >= cfg.delay
               and neigh.ago % cfg.every == 0)
    if checked and not neigh.list_gated:
        return neigh
    refresh_pairlist(s.x, neigh.valid, list_box(s, ctx), cfg, neigh.pairs,
                     neigh.npairs, neigh.list_stat, neigh.list_hold)
    return neigh if neigh.list_gated else neigh.replace(list_gated=True)


def step_pre(s: MDState, neigh, fstates, ctx: StepContext, istep: int,
             xs):
    """The first part of a step to timestep istep: the integrators' first
    half (a fix with ``xs_in_pre`` takes its input xs[i] there), the
    rebuild decision and the force evaluation; returns (s, neigh, fstates,
    virial: the step's virial where a fix needs it, else None)."""
    fstates = list(fstates)
    for i, fx in enumerate(ctx.fixes):
        if fx.needs_step:
            fstates[i] = fx.set_step(fstates[i], istep)
        if fx.xs_in_pre:
            s, fstates[i] = fx.initial_integrate(s, fstates[i], ctx, xs[i])
        else:
            s, fstates[i] = fx.initial_integrate(s, fstates[i], ctx)
    for i, fx in enumerate(ctx.fixes):
        if getattr(fx, "needs_neigh", False):
            s, fstates[i] = fx.post_integrate(s, fstates[i], ctx, neigh)
        else:
            s, fstates[i] = fx.post_integrate(s, fstates[i], ctx)
    neigh = neigh.replace(ago=neigh.ago + 1)
    # a fix that edits the bonds at its event steps (bond/create,
    # bond/break) has the neighbor list rebuilt that step, so that its
    # special codes follow (the reference's next_reneighbor)
    forced = any(getattr(fx, "rebuild_every", 0)
                 and istep % fx.rebuild_every == 0 for fx in ctx.fixes)
    if forced or decide_rebuild(s, neigh, ctx):
        s, neigh = _rebuild(s, neigh, ctx)
    else:
        if ctx.decomp is not None and ctx.is_cellgrid:
            # the halo slots' positions of this step, before the refresh
            s = s.replace(x=ctx.decomp.exchange_positions(s.x, s.box))
        if ctx.pairlist_refresh:
            neigh = refresh_list(s, neigh, ctx)
    f, _, virial, torque, neigh = compute_forces(
        s, neigh, ctx, eflag=False, vflag=ctx.need_virial, shearupdate=True,
        istep=istep)
    s = s.replace(f=f) if torque is None else s.replace(f=f, torque=torque)
    return s, neigh, tuple(fstates), virial


def step_post(s: MDState, neigh, fstates, ctx: StepContext, xs, virial):
    """The rest of a step after its force evaluation: post_force (with
    each fix's input xs[i]), final_integrate and end_of_step, each in the
    fixes' deck order (tpumd/md/verlet.py:469-488)."""
    fstates = list(fstates)
    need_virial = ctx.need_virial
    for i, fx in enumerate(ctx.fixes):
        s, fstates[i] = fx.post_force(s, fstates[i], ctx, xs[i])
        if need_virial and fx.contributes_virial:
            virial = virial + fx.virial_contrib(fstates[i])
    for i, fx in enumerate(ctx.fixes):
        if fx.needs_virial:
            fstates[i] = fx.save_virial(fstates[i], virial)
        s, fstates[i] = fx.final_integrate(s, fstates[i], ctx)
    for i, fx in enumerate(ctx.fixes):
        s, fstates[i] = fx.end_of_step(s, fstates[i], ctx)
    return s, neigh, tuple(fstates)


def step(s: MDState, neigh, fstates, ctx: StepContext,
         xs, istep: int):
    """One velocity-Verlet step to timestep istep; xs holds each fix's
    input of this step (or None)."""
    s, neigh, fstates, virial = step_pre(s, neigh, fstates, ctx, istep, xs)
    return step_post(s, neigh, fstates, ctx, xs, virial)


def run_segment(s: MDState, neigh, fstates,
                ctx: StepContext, nsteps: int, xs=None, step0: int = 0):
    """nsteps steps from timestep step0 (rRESPA steps under run_style
    respa); xs: per fix, None or its inputs stacked over the segment's
    steps."""
    if xs is None:
        xs = (None,) * len(ctx.fixes)
    one = step if ctx.respa is None else respa_step
    for k in range(nsteps):
        s, neigh, fstates = one(s, neigh, fstates, ctx,
                                [None if x is None else x[k] for x in xs],
                                step0 + k + 1)
    return s, neigh, fstates


# --------------------------------------------------------------- rRESPA
# the level forces ride the state's per-atom tables, so that a re-bin
# moves them with the atoms and a redone segment starts from its own
RESPA_KEY = "respa level {}"


def respa_fixes(ctx: StepContext):
    """(integrators, hook fixes) of the respa step (tpumd/md/verlet.py:
    725-757): fix nve integrates every level by hand; every other fix runs
    its post_force on the outermost level's forces (the reference's
    default level, src/fix.cpp ilevel_respa), ``post_force_respa_lower``
    on the inner ones, and end_of_step once an outer step.  A fix that
    integrates, needs the virial or moves the box raises."""
    from tpumd_torch.md.fixes import Fix, FixNVE
    integ, hooks = [], []
    for i, fx in enumerate(ctx.fixes):
        if type(fx) is FixNVE:
            integ.append(fx)
            continue
        cls = type(fx)
        if (cls.initial_integrate is not Fix.initial_integrate
                or cls.post_integrate is not Fix.post_integrate
                or cls.final_integrate is not Fix.final_integrate
                or fx.needs_virial or fx.box_change or fx.eos_box_change
                or fx.xs_in_pre):
            raise NotImplementedError(
                f"run_style respa with fix {getattr(fx, 'id', '')} "
                f"{getattr(fx, 'name', cls.__name__)}: only fix nve "
                "integrates under respa, beside post_force and end_of_step "
                "fixes (as in tpumd)")
        hooks.append((i, fx))
    if not integ:
        raise NotImplementedError("run_style respa needs a fix nve")
    return integ, hooks


def respa_forces(s: MDState, neigh, ctx: StepContext, fstates, xs=None):
    """Every level's forces of state s with the fixes' post_force hooks
    applied to them (Respa::setup, src/respa.cpp; tpumd's
    respa_setup_hooks); returns (s with f their sum and the levels in its
    per-atom tables, fstates)."""
    _, hooks = respa_fixes(ctx)
    fstates = list(fstates)
    flev = []
    for lvl, cats in enumerate(ctx.respa[1]):
        f = compute_forces(s, neigh, ctx, False, False, cats=cats)[0]
        f, fstates = _level_hooks(s, f, lvl, hooks, fstates, ctx, xs)
        flev.append(f)
    return _with_levels(s, flev), tuple(fstates)


def _level_hooks(s, f, lvl, hooks, fstates, ctx, xs):
    """The hook fixes on one level's new forces f: post_force on the
    outermost level, post_force_respa_lower below it."""
    outer = lvl == len(ctx.respa[1]) - 1
    t = s.replace(f=f)
    for i, fx in hooks:
        if outer:
            t, fstates[i] = fx.post_force(t, fstates[i], ctx,
                                          None if xs is None else xs[i])
        elif hasattr(fx, "post_force_respa_lower"):
            t, fstates[i] = fx.post_force_respa_lower(t, fstates[i], ctx)
    return t.f, fstates


def _with_levels(s, flev):
    return s.replace(f=sum(flev), peratom={
        **(s.peratom or {}),
        **{RESPA_KEY.format(k): f for k, f in enumerate(flev)}})


def respa_step(s: MDState, neigh, fstates, ctx: StepContext, xs,
               istep: int):
    """One outer rRESPA step (Respa::recurse, src/respa.cpp;
    tpumd/md/verlet.py:786-857): the rebuild decision once, at the outer
    level before any drift; then at each level, loop[level] times, a half
    kick with that level's forces, the level below (the innermost level
    drifts the positions), that level's new forces and another half
    kick."""
    loops, cats = ctx.respa
    nlev = len(cats)
    integ, hooks = respa_fixes(ctx)
    fstates = list(fstates)
    for i, fx in enumerate(ctx.fixes):
        if fx.needs_step:
            fstates[i] = fx.set_step(fstates[i], istep)
    neigh = neigh.replace(ago=neigh.ago + 1)
    if decide_rebuild(s, neigh, ctx):
        s, neigh = _rebuild(s, neigh, ctx)
    elif ctx.pairlist_refresh:
        neigh = refresh_list(s, neigh, ctx)
    flev = [s.peratom[RESPA_KEY.format(k)] for k in range(nlev)]
    # step[L-1] = dt, step[l] = step[l+1] / loop[l] (Respa::init)
    dts = [ctx.dt] * nlev
    for lv in range(nlev - 2, -1, -1):
        dts[lv] = dts[lv + 1] / loops[lv]
    sel = integ[0].group_sel(s)
    for fx in integ[1:]:
        sel = sel | fx.group_sel(s)
    inv_m = (1.0 / ctx.mass_per_atom(s))[:, None]

    def kick(s, lvl):
        v = s.v + (0.5 * dts[lvl] * ctx.units.ftm2v) * flev[lvl] * inv_m
        return s.replace(v=torch.where(sel[:, None], v, s.v))

    def recurse(s, lvl):
        for _ in range(loops[lvl]):
            s = kick(s, lvl)
            if lvl > 0:
                s = recurse(s, lvl - 1)
            else:
                s = s.replace(x=torch.where(sel[:, None],
                                            s.x + dts[0] * s.v, s.x))
            f = compute_forces(s, neigh, ctx, False, False, cats=cats[lvl])[0]
            flev[lvl], fs = _level_hooks(s, f, lvl, hooks, fstates, ctx, xs)
            fstates[:] = fs
            s = kick(s, lvl)
        return s

    s = _with_levels(recurse(s, nlev - 1), flev)
    for i, fx in hooks:
        s, fstates[i] = fx.end_of_step(s, fstates[i], ctx)
    return s, neigh, tuple(fstates)


def eval_energies(s: MDState, neigh, ctx: StepContext):
    """Force + energy + virial evaluation for thermo output steps; the
    contact history is read, not advanced (the reference's shearupdate 0
    outside the step, pair_gran_hooke_history.cpp:187)."""
    return compute_forces(s, neigh, ctx, eflag=True, vflag=True)


def pack_thermo(s: MDState, energies, virial, scal, mass_table,
                extra=()):
    """Thermo vector on the device, fetched with one transfer.

    Layout: [temp, vol, sum(vir[:3]), natoms, lengths(3), energies in
    ENERGY_KEYS order, extra].  scal = (dof, boltz, mvv2e); extra holds
    () tensors (compute values, counts of escaped atoms)."""
    dof, boltz, mvv2e = scal
    if s.rmass is not None:
        mass = torch.where(s.rmass > 0, s.rmass, 1.0)
    else:
        mass = torch.index_select(mass_table, 0, s.type)
    t_dev = computes.temperature(s.v, mass, dof, boltz, mvv2e)
    dt_ = s.x.dtype
    ell = s.box.lengths
    return torch.cat([
        torch.stack([t_dev, s.box.volume, torch.sum(virial[:3]),
                     torch.sum(s.tag > 0).to(dt_)]),
        ell, torch.stack([energies[k] for k in ENERGY_KEYS]
                         + [e.to(dt_) for e in extra])])
