"""Host-side simulation orchestrator.

Plays the role of the reference's Update + Run + Thermo + Finish
(src/run.cpp, src/thermo.cpp, src/finish.cpp), as tpumd/md/simulation.py
does for the cell-grid path: owns the styles, fixes and state, segments a
run between thermo outputs, and reads the device once per segment (the
neighbor overflow flag and the thermo row).  Molecular decks bring the
topology from read_data: on the cell grid FENE bonds ride the pair kernel
(``_setup_kernel_bond``); every other bonded style, and FENE on the matrix
engine, is evaluated per tuple, minus the bonds and angles that SHAKE
constrains.  A breakable style (bond quartic) carries an alive flag per
bond, which the built-in fix bond_break clears.  Under a barostat the
cell grid keeps a margin and is re-validated after each segment, as it is
under shrink-wrapped faces.  A granular style carries its contact history
in the grid state (zero at set-up, moved with the atoms by every re-bin);
the one read per segment also says whether some atom's history is full.

A fix that moves the box at end_of_step (press/berendsen, deform) ends each
segment with a split step, whose force evaluation thermo reads; the
minimize command runs ``md/minimize.py`` from the set-up state.

Two neighbor engines (``neighbor_mode``, chosen at set-up by
``_resolve_mode``): the cell grid, where the atoms sit in grid-slot order,
and the matrix engine (``ops/neighbor.py``), where they keep their rows and
a padded (N, K) neighbor list holds the pairs.  The matrix engine takes
what the grid cannot: every pairwise style without a grid kernel (the
pair-style library, hybrid, lj/charmm/coul/long without special lists,
DPD, TIP4P), kspace (every style) beside its pair styles, any number of lj/cut
types, non-periodic axes for every pairwise style, boxes narrower than 2
cutneigh and triclinic boxes, and the bonded styles and SHAKE beside any
pairwise style (``_grid_refusal`` says which bonded decks the grid
cannot take).

On the grid the bonded styles read the tag-order view of the atoms by
default; with ``bonded_grid`` (tpumd's attribute) they and fix shake
find their members by tag among the grid's slots
(``_setup_grid_tuples``, ops/cellgrid_tuples.py), the path a decomposed
grid takes whatever it says.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpumd_torch.core.state import MDState, map_per_atom, wrap_pbc
from tpumd_torch.md import computes
from tpumd_torch.md.compute_styles import split_ref
from tpumd_torch.md.computes import THERMO_COMPUTES
from tpumd_torch.md.fixes import FixBondBreak
from tpumd_torch.io.read_data import build_special
from tpumd_torch.md.verlet import ENERGY_KEYS, StepContext, build_matrix, \
    eval_energies, grid_pairlist, pack_thermo, partner_tags, rebuild_now, \
    remap_history_by_tag, respa_forces, run_segment, step_post, step_pre
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import neighbor as nb
from tpumd_torch.ops.cellgrid_gran import KH
from tpumd_torch.parallel.decomp import GridDecomp, RowDecomp
from tpumd_torch.parallel.mesh import Mesh
from tpumd_torch.utils.units import Units, get_units

THERMO_KEYS = ("step", "temp", "epair", "emol", "pe", "ke", "etotal",
               "press", "vol", "lx", "ly", "lz", "xy", "xz", "yz", "atoms",
               "density") + ENERGY_KEYS
# thermo_style custom also takes c_ID (the scalar of compute ID, or of
# the reference's thermo computes), v_name and f_ID[i]
# (Simulation._thermo_value)

# the barostat's first cell margin, widened 10 % per violation
# (tpumd/md/simulation.py:154-158, :1429)
BARO_MARGIN = 1.12
# a shrink-wrapped face sits this fraction of the initial box length
# beyond the outermost atom (SMALL, src/domain.cpp:46)
SMALL = 1.0e-4


# the keys of a granular style's contact history in MDState.peratom between
# a run and the next set-up: each atom's partner tags and their shears
PAIR_HISTORY = ("pair history tags", "pair history shear")


def _pop_history(s: MDState):
    """(s without the contact history in its per-atom tables, (partner
    tags, shears) or None)."""
    if not s.peratom or PAIR_HISTORY[0] not in s.peratom:
        return s, None
    table = dict(s.peratom)
    history = (table.pop(PAIR_HISTORY[0]), table.pop(PAIR_HISTORY[1]))
    return s.replace(peratom=table), history


def resolve_device(device) -> torch.device:
    """The device a run asked for; asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda."
                           "is_available() is False")
    return dev


class Simulation:
    # the grid's bonded styles and fix shake match their members by tag
    # (ops/cellgrid_tuples.py); off by default on one card, where the
    # tag-order view is one gather; a decomposed grid takes it whatever
    # this says (tpumd/md/simulation.py:283-286)
    bonded_grid = False

    def __init__(self, units: str = "lj", *, device, dtype, mesh=None):
        self.units: Units = get_units(units)
        self.device = resolve_device(device)
        # the process group a run is decomposed over (a world of one
        # without one: the one-card run)
        self.mesh: Mesh = Mesh(device=self.device) if mesh is None else mesh
        self.dtype = dtype
        self.dt = self.units.dt
        self.skin = self.units.skin
        self.neigh_every = 1
        self.neigh_delay = 10
        self.neigh_check = True
        # "matrix": the padded neighbor matrix (exact list semantics, any
        # box); "cellgrid": the cell grid and its kernels; "auto": the
        # grid where it takes the case (_resolve_mode)
        self.neighbor_mode = "auto"

        self.state: MDState | None = None
        self.mass = None               # (ntypes+1,) numpy
        self.ntypes = 0
        self.pair = None
        self.kspace = None
        self.fixes: list = []
        self.bonded: dict = {}         # kind -> style, in command order
        self.bonded_ntypes: dict = {}  # kind -> type count (read_data)
        self.topology: dict = {}       # kind -> (M, 1+arity) type, tags
        self.special_lj = None         # (4,) weights or None
        self.special_coul = None
        self.special_tags = None       # (N, S) by tag-1, build_special
        # molecule templates by ID (io/molecule.py), and the room that
        # create_box or read_data asked for (extra/<kind>/per/atom)
        self.molecules: dict = {}
        self.extra_per_atom: dict = {}
        self._special_width = None     # the running special lists' width
        # fix states a restart file saved, by fix ID (io/restart.py)
        self.restart_fstates: dict = {}
        self.special_codes = None

        self.thermo_every = 0          # 0: only first/last
        self.thermo_style = ["step", "temp", "epair", "emol", "etotal",
                             "press"]
        self.thermo_norm = units == "lj"
        # run_style respa: (loop factors, the terms of each level)
        self.respa = None
        self.thermo_multi = False      # thermo_style multi
        self.lost_policy = "error"     # thermo_modify lost
        self.log_lines: list[str] = []
        self.dimension = 3
        self.verbose = True
        self.boundary = ("p", "p", "p")   # per axis: p, or lo/hi of f s m
        self.groups = {"all": 1}          # name -> gmask bit
        self.neigh_exclude = ()           # ((bit1, bit2), ...)
        self.computes: dict = {}          # id -> compute
        # fix property/atom's custom columns by name, arrays by tag - 1
        self.custom_peratom: dict = {}
        # why a fix halt stopped the run (None: it did not)
        self.halt = None
        # occasional neighbor lists the distance computes built
        # (md/compute_list.py), and the list kernel's launches for them
        self.analysis_lists = 0
        self.analysis_grid_lists = 0
        self._energies_of = None       # the state _last_energies are of
        self._shrink_small = None         # SMALL * the first box lengths
        self._hist_warned = False

        self._ctx: StepContext | None = None
        self._carry = None             # (state, neigh, fix states)
        self._neigh_cfg: cg.CellGridConfig | nb.NeighborConfig | None = None
        self._mode = None              # the engine of the set-up
        self._cap_override = None
        # K of the matrix engine's rows or of the grid's pair list
        self._kmax_override = None
        self._cellcap_override = None
        self._baro_margin = BARO_MARGIN
        self._natoms = None
        self._mass_sum = None
        self._kernel_bond = None
        self._bonded_grid_on = False
        self._ref_order_tags = None
        self._bonded_dev = ()
        self._fstate_stash: dict = {}
        self.grid_setups = 0           # fresh grids binned (_grid_setup)
        self.steps_redone = 0          # steps of segments redone on overflow
        self._refreshes = 0            # list refreshes of earlier grids
        self.step = 0
        self.last_thermo: dict | None = None
        # every printed thermo row, as a dict (PyLammps' run capture)
        self.thermo_rows: list[dict] = []
        self.loop_time = 0.0
        self.loop_steps = 0
        self.script = None             # the LammpsScript, for v_ columns
        self.dumps: list = []          # io.dump.Dump, in command order
        self.log_fh = None             # the log command's file
        # the timer command's timeout (src/timer.cpp): a wall-clock limit
        # in seconds from the first run, checked at segment boundaries
        self.timer_timeout = None
        self._wall_start = None
        # the minimize command's style (tpumd's default, not LAMMPS's cg)
        # and the figures of the last minimization (md/minimize.py)
        self.min_style = "fire"
        self.min_stats: dict | None = None

    # ------------------------------------------------------------------ setup
    @property
    def natoms(self) -> int:
        if self.state is None:
            return 0
        if self._natoms is None:
            self._natoms = int((self.state.tag > 0).sum())
        return self._natoms

    def dof(self) -> float:
        fix_dof = sum(fx.dof_removed for fx in self.fixes)
        return self.dimension * self.natoms - self.dimension - fix_dof

    def max_cutoff(self) -> float:
        return self.pair.max_cutoff if self.pair is not None else 0.0

    def _barostat_active(self) -> bool:
        """A fix moves the box between rebuilds: fix npt/nph, rigid/npt or
        rigid/nph (tpumd/md/simulation.py:1407-1410)."""
        return any(fx.box_change for fx in self.fixes)

    @property
    def granular(self) -> bool:
        return getattr(self.pair, "is_granular", False)

    def _shrink_spec(self) -> tuple:
        """((dim, shrink_lo, shrink_hi, small), ...) of the s/m faces
        (tpumd/md/simulation.py:391-401); small is fixed by the box at the
        first set-up."""
        spec = []
        for d, tok in enumerate(self.boundary):
            lo_, hi_ = tok[0], tok[-1]
            if lo_ in "sm" or hi_ in "sm":
                spec.append((d, lo_ in "sm", hi_ in "sm",
                             float(self._shrink_small[d])))
        return tuple(spec)

    def _reset_box_host(self):
        """Shrink-wrap at set-up (Domain::reset_box, tpumd/md/simulation.py
        :749-767), on the host from the compact state."""
        spec = self._shrink_spec()
        if not spec:
            return
        box = self.state.box
        x = self.state.x.detach().cpu().numpy().astype(np.float64)
        x = x[self.state.tag.cpu().numpy() > 0]
        lo = box.lo.cpu().numpy().astype(np.float64)
        hi = box.hi.cpu().numpy().astype(np.float64)
        for d, slo, shi, small in spec:
            if shi:
                hi[d] = x[:, d].max() + small
            if slo:
                lo[d] = x[:, d].min() - small
        self.state = self.state.replace(box=box.replace(
            lo=torch.as_tensor(lo, dtype=self.dtype, device=self.device),
            hi=torch.as_tensor(hi, dtype=self.dtype, device=self.device)))

    def _special_weights(self):
        """The lj and coul special_bonds weights by code 0..3; the default
        is 0 0 0 (Force::Force, src/force.cpp:61)."""
        default = (1.0, 0.0, 0.0, 0.0)
        slj = default if self.special_lj is None else self.special_lj
        scl = default if self.special_coul is None else self.special_coul
        return (tuple(float(w) for w in slj), tuple(float(w) for w in scl))

    def _resolve_mode(self) -> str:
        """The engine of this set-up (tpumd/md/simulation.py:113-143, with
        no backend key): the cell grid when its kernels take the style,
        every axis is periodic, the box is orthogonal and at least 2
        cutneigh wide; else the matrix engine.  The port differs in two
        ways: a granular style stays on the grid with non-periodic axes
        (B6 takes them, and runs there on the card), and a case that the
        grid's kernels refuse (lj/cut with several types, a
        ``neigh_modify exclude`` beside B1-B5, the bonded decks of
        ``_grid_refusal``) goes to the matrix engine.
        A granular deck reaches the matrix engine when an axis is
        narrower than 2 cutneigh: a bed a few grains deep under a
        shrink-wrapped top (non-periodic, so it needs no image copies)."""
        if self.neighbor_mode not in ("auto", "cellgrid", "matrix"):
            raise ValueError(f"neighbor_mode {self.neighbor_mode!r}: auto, "
                             "cellgrid or matrix")
        if self.neighbor_mode != "auto":
            return self.neighbor_mode
        box = self.state.box
        cutneigh = self.max_cutoff() + self.skin
        # the grid's charged sweep (B5) reads the special lists: a charged
        # deck without bonds goes to the matrix engine; so does a bonded
        # deck that the grid's kernels cannot take (_grid_refusal)
        eligible = (
            self.pair is not None and self.pair.supports_cellgrid
            and self._grid_refusal() is None
            and (self.special_tags is not None
                 or not getattr(self.pair, "charged", False))
            and (self.granular or (all(box.periodic)
                                   and not self.neigh_exclude))
            and not box.istriclinic
            and bool(np.all(box.lengths_np() >= 2.0 * cutneigh)))
        return "cellgrid" if eligible else "matrix"

    def _matrix_config(self, cutneigh: float,
                       margin: float) -> nb.NeighborConfig:
        """The matrix engine's config (tpumd/md/simulation.py:189-243); the
        cell capacity fits the atoms' actual occupancy unless overridden."""
        cfg = nb.choose_config(
            self.state.box, cutneigh, self.skin, self.natoms,
            every=self.neigh_every, delay=self.neigh_delay,
            check=self.neigh_check,
            has_special=self.state.special_tags is not None,
            kmax=self._kmax_override, cell_cap=self._cellcap_override,
            box_margin=margin)
        cfg = dataclasses.replace(cfg, exclude_bits=tuple(self.neigh_exclude))
        if self._cellcap_override is None and not cfg.image_shifts:
            # the density rule oversizes settled granular packs, and the
            # build's cost grows with the cap; granular contacts bound the
            # occupancy (+2), point particles diffuse (30 % more, +2)
            cid, _ = nb._cell_index(self.state.x, self.state.box, cfg)
            occ = int(torch.bincount(cid, minlength=cfg.ncells).max())
            if self.granular:
                tight = int(np.ceil((occ + 2) / 2) * 2)
            else:
                tight = int(np.ceil((occ * 1.3 + 2) / 2) * 2)
            if tight < cfg.cell_cap:
                cfg = dataclasses.replace(cfg, cell_cap=tight)
        if cfg.image_shifts and self.pair is not None \
                and not self.pair.supports_image_ext:
            raise NotImplementedError(
                f"pair_style {self.pair.name}: a box narrower than "
                "2*cutneigh needs the multi-image mode, which this style "
                "does not take")
        return cfg

    def _make_ctx(self) -> StepContext:
        cutneigh = self.max_cutoff() + self.skin
        # under a barostat, cells keep a margin so that moderate box
        # shrinkage leaves their edges >= cutneigh (re-validated after
        # each segment)
        margin = self._baro_margin if self._barostat_active() else 1.0
        if self._mode == "matrix":
            cfg = self._matrix_config(cutneigh, margin)
        else:
            cfg = self._grid_config(cutneigh, margin)
        self._neigh_cfg = cfg
        decomp = None
        if self.mesh.distributed:
            # the run over the process group: the grid's bricks (the
            # context's grid is then the rank's local grid) or the
            # matrix engine's row blocks
            if self._mode == "matrix":
                if cfg.image_shifts:
                    raise NotImplementedError(
                        "a box narrower than 2*cutneigh (the matrix "
                        f"engine's image copies) across {self.mesh.size} "
                        "ranks is not ported (ROADMAP item 14b)")
                decomp = RowDecomp(self.mesh, self.natoms)
            else:
                decomp = GridDecomp(self.mesh, cfg)
        pairlist_k, exclude, refresh = 0, (), False
        # every style on the grid sweeps a list (FENE bonds riding lj/cut's
        # kernel are coded in it); a schedule that leaves steps unchecked
        # refreshes it where stale
        if self._mode == "cellgrid" and self.pair is not None:
            pairlist_k = self._kmax_override or cg.pairlist_kmax(
                self.state.box, cutneigh, self.natoms)
            exclude = tuple(self.neigh_exclude)
            refresh = not (cfg.check and cfg.every == 1 and cfg.delay <= 1)
        mass_np = np.asarray(self.mass, dtype=np.float64).copy()
        mass_np[0] = 1.0  # padded slots: finite mass, zero force
        slj, scl = self._special_weights()
        return StepContext(
            units=self.units, dt=self.dt,
            neigh_cfg=cfg if decomp is None or decomp.kind == "rows"
            else decomp.local_cfg, pair=self.pair,
            fixes=tuple(self.fixes),
            mass_table=torch.as_tensor(mass_np, dtype=self.dtype,
                                       device=self.device),
            natoms=self.natoms, kernel_bond=self._kernel_bond,
            ref_order_tags=self._ref_order_tags, bonded=self._bonded_dev,
            kspace=self.kspace, special_lj=slj, special_coul=scl,
            tdof=self.dof(), shrink=self._shrink_spec(),
            pairlist_k=pairlist_k, pairlist_exclude=exclude,
            pairlist_refresh=refresh, respa=self.respa, decomp=decomp,
            bonded_grid=self._bonded_grid_on)

    def _grid_config(self, cutneigh: float,
                     margin: float) -> cg.CellGridConfig:
        """The cell grid's config."""
        # cell-size factor: cells of F*cutneigh (stencil stays +-1); grow F
        # while the mean cell occupancy is far below a dense cap
        # (tpumd/md/simulation.py:159-185)
        ell = self.state.box.lengths_np()
        cell_factor = 1.0
        while cell_factor < 4.0:
            ncell = np.prod(np.maximum(1, np.floor(
                ell / (cutneigh * margin * (cell_factor * 2))).astype(int)))
            if ncell < 27 or self.natoms / ncell > 28.0:
                break
            cell_factor *= 2
        return cg.choose_cellgrid_config(
            self.state.box, cutneigh, self.skin, self.natoms,
            every=self.neigh_every, delay=self.neigh_delay,
            check=self.neigh_check, cap=self._cap_override,
            box_margin=margin * cell_factor)

    def _grid_refusal(self):
        """Why the cell grid's kernels cannot take this deck's pair style
        (its ``grid_refusal``) or bonded styles, so that "auto" sends it to
        the matrix engine, or None.
        Per-tuple styles need the special pairs weighed in the pair sweep:
        B5's charged sweep and single-type lj/cut's (B1's special-weighted
        variant, ``grid_special``) do that.  FENE rides B2 only on its own,
        with at most 2 partners an atom.  (FENE's other limits in B2, one
        bond type, R0 within cutneigh and ``special_bonds fene``, raise at
        ``_setup_kernel_bond``.)"""
        for fx in self.fixes:
            if isinstance(getattr(fx, "grid_refusal", None), str):
                return fx.grid_refusal
        if self.respa is not None and any(
                self.topology.get(k) is not None and len(self.topology[k])
                for k in self.bonded):
            return ("run_style respa puts the bonded and pair terms on "
                    "separate levels: the grid's kernels sum them together "
                    "(B2) or weigh the special pairs only beside B5")
        if self.pair is not None and self.pair.supports_cellgrid:
            why = self.pair.grid_refusal()
            if why:
                return why
        kinds = {k: st for k, st in self.bonded.items()
                 if self.topology.get(k) is not None
                 and len(self.topology[k])}
        fene = [st for st in kinds.values() if st.kernel_bond]
        tuple_styles = [f"{k}_style {st.name}" for k, st in kinds.items()
                        if not st.kernel_bond]
        name = getattr(self.pair, "name", None)
        if tuple_styles and not self._grid_weighs_special():
            return (f"{', '.join(tuple_styles)} beside pair_style {name}: "
                    "the grid evaluates per-tuple bonded styles only beside "
                    "the sweeps that weigh the special pairs, "
                    "lj/charmm/coul/long's (B5) and single-type lj/cut's "
                    "(B1)")
        if not fene:
            return None
        if tuple_styles:
            return (f"bond_style {fene[0].name} beside "
                    f"{', '.join(tuple_styles)}: FENE rides the LJ+FENE "
                    "kernel (B2) only on its own")
        bonds = np.asarray(self.topology["bond"])
        most = int(np.bincount(bonds[:, 1:].ravel()).max())
        if most > 2:
            return (f"an atom with {most} FENE bond partners: the LJ+FENE "
                    "kernel (B2) holds at most 2")
        return None

    def _grid_weighs_special(self) -> bool:
        """Whether the pair style's grid sweep weighs the list's special
        pairs: B5's charged sweep, or single-type lj/cut's (B1-special)."""
        pair = self.pair
        return getattr(pair, "charged", False) or (
            getattr(pair, "grid_special", False) and pair.supports_cellgrid)

    def _setup_kernel_bond(self):
        """Route FENE bonds into the pair kernel on the grid
        (tpumd/md/simulation.py:329-389): per-row (N, B) partner-tag and
        bond-type tables ride the state, so they permute with the atoms,
        and the kernel matches them like a special list (a FENE deck that
        ``_grid_refusal`` names went to the matrix engine); the kernel's
        other limits raise here."""
        self._kernel_bond = None
        bonds, style = self.topology.get("bond"), self.bonded.get("bond")
        if self._mode != "cellgrid" or bonds is None or len(bonds) == 0 \
                or style is None or not style.kernel_bond:
            return
        if self.pair is None:
            raise NotImplementedError(
                "bond_style fene needs a pair_style to ride the pair "
                "kernel: the port has no other FENE path on the grid")
        cutneigh = self.max_cutoff() + self.skin
        if not 0 < style.kernel_reach <= cutneigh:
            raise NotImplementedError(
                f"bond_style {style.name}: reach {style.kernel_reach} is "
                f"not within cutneigh {cutneigh}, so its partners may lie "
                "outside the cell stencil")
        # the special pass collapses into the bond hit when the entries
        # the grid would keep (weight != 1) are exactly the 1-2 pairs, at
        # weight 0: the only case the kernel takes
        collapse = False
        if self.special_tags is not None and self.special_lj is not None \
                and float(self.special_lj[1]) == 0.0:
            st = np.asarray(self.special_tags)
            sc = np.asarray(self.special_codes)
            kept = (st > 0) & (np.asarray(self.special_lj)[sc] != 1.0)
            collapse = bool((sc[kept] == 1).all())
        if not collapse:
            raise NotImplementedError(
                "bonds whose special list does not collapse to the bond "
                "partners at weight 0 (special_bonds fene): the LJ+FENE "
                "kernel takes only that case")
        n = self.natoms
        tags = self.state.tag.cpu().numpy()
        row_of_tag = np.zeros(n + 1, dtype=np.int64)
        row_of_tag[tags] = np.arange(n)
        bt = np.asarray(bonds)
        # both directions of each bond: first every bond as seen from its
        # first atom, then from its second, in bond order within a row
        rows = row_of_tag[np.concatenate([bt[:, 1], bt[:, 2]])]
        partner = np.concatenate([bt[:, 2], bt[:, 1]])
        btype = np.concatenate([bt[:, 0], bt[:, 0]])
        order = np.argsort(rows, kind="stable")
        rows = rows[order]
        col = np.arange(len(rows)) - np.searchsorted(rows, rows, "left")
        btags = np.zeros((n, int(col.max()) + 1), np.int32)
        btyps = np.zeros_like(btags)
        btags[rows, col] = partner[order]
        btyps[rows, col] = btype[order]
        self.state = self.state.replace(
            bond_tags=torch.as_tensor(btags, device=self.device),
            bond_btypes=torch.as_tensor(btyps, device=self.device))
        self._kernel_bond = style

    def _setup_grid_tuples(self, excl):
        """The per-atom tables of the tag-matched bonded path and of fix
        shake's clusters, installed in the state's rows (they then ride
        the atoms), where the grid takes that path: ``bonded_grid``, or a
        decomposed grid, whose local grids have no global tag map
        (tpumd/md/simulation.py:288-327).  One style a kind: hybrid
        raises, as does a breakable style (fix bond/break).  Every tuple's
        span must sit within cutneigh at the set-up."""
        from tpumd_torch.md.fix_shake import FixShake
        from tpumd_torch.ops import cellgrid_tuples as ct
        self._bonded_grid_on = False
        if self._mode != "cellgrid" or not (self.bonded_grid
                                            or self.mesh.distributed):
            return
        styles = [st for k, st in self.bonded.items()
                  if st is not self._kernel_bond
                  and self.topology.get(k) is not None
                  and len(self.topology[k])]
        shakes = [fx for fx in self.fixes if type(fx) is FixShake]
        if not styles and not shakes:
            return
        for st in styles:
            if st.name == "hybrid" or st.breakable:
                raise NotImplementedError(
                    f"{st.kind}_style {st.name} with bonded_grid (the "
                    "tag-matched path, which a decomposed grid takes): it "
                    "takes one plain style a kind, as in tpumd")
        arities = {st.kind: st.arity for st in styles}
        topo = {k: self.topology[k] for k in arities}
        tags = self.state.tag.cpu().numpy()
        x = np.zeros((self.natoms, 3))
        x[tags - 1] = self.state.x.detach().cpu().double().numpy()
        # the stencil reaches one cell edge, and cells are at least
        # cutneigh across
        ct.validate_tuple_span(x, topo, arities, self.state.box.lengths_np(),
                               self.state.box.periodic,
                               self.max_cutoff() + self.skin, excl)
        tables = ct.build_tuple_tables(self.natoms, topo, arities, excl)
        self.state = self.state.replace(peratom={
            **(self.state.peratom or {}),
            **{k: torch.as_tensor(v[tags - 1], device=self.device)
               for k, v in tables.items()}})
        for fx in shakes:
            fx.install_grid_tables(self)
        self._bonded_grid_on = True

    def live_topology(self, kind):
        """The tuples of kind as the run has them now (host, (M, 1 +
        arity): type, then the members' tags), or None: the topology, less
        the bonds a fix broke and with those it made (fix bond/break and
        bond/create read their device state back)."""
        arr = self.topology.get(kind)
        for fx in self.fixes:
            if hasattr(fx, "edit_topology"):
                arr = fx.edit_topology(self, kind, arr)
        return arr

    def shake_fixes(self):
        """fix shake and fix rattle, which share the clusters."""
        return [fx for fx in self.fixes
                if getattr(fx, "name", "") in ("shake", "rattle")]

    def build_shake(self):
        """Find every fix shake's clusters on the current topology; returns
        the data-file rows of the bonds and angles they constrain."""
        excl = {"bond": set(), "angle": set()}
        shakes = self.shake_fixes()
        if not shakes:
            return excl
        bond, angle = self.bonded.get("bond"), self.bonded.get("angle")
        if self.topology.get("bond") is None or bond is None:
            raise ValueError("fix shake requires bonds and a bond_style")
        types = np.zeros(self.natoms, np.int64)
        types[self.state.tag.cpu().numpy() - 1] = \
            self.state.type.cpu().numpy()
        for fx in shakes:
            eb, ea = fx.build_clusters(
                self.topology["bond"], self.topology.get("angle"), types,
                self.mass, bond.r0,
                None if angle is None else angle.theta0)
            excl["bond"].update(eb)
            excl["angle"].update(ea)
        return excl

    def _setup_bonded(self, excl):
        """Per-tuple styles with their tuples on the device (type, then
        the members as tag-1; int32 on the matrix engine, whose gathers
        are P1's), minus SHAKE's constrained rows; a hybrid's sub-styles
        each with their own.  A breakable style's alive flags are made
        once and kept over later set-ups of the same tuples, and the
        built-in fix bond_break joins the fixes."""
        out = []
        index = torch.int64 if self._mode == "cellgrid" else torch.int32
        for kind, style in self.bonded.items():
            style.units = self.units
            style.init()
            tuples = self.topology.get(kind)
            if tuples is None or len(tuples) == 0 or (
                    style.kernel_bond and self._mode == "cellgrid"):
                continue
            if excl.get(kind):
                keep = [i for i in range(len(tuples))
                        if i not in excl[kind]]
                tuples = tuples[keep]
            t = np.array(tuples, dtype=np.int64)
            t[:, 1:] -= 1
            for sub, part in style.parts(t):
                dev = torch.as_tensor(part, dtype=index, device=self.device)
                if sub.breakable:
                    self._setup_alive(sub, dev)
                out.append((sub, dev))
        for fx in self.fixes:
            if hasattr(fx, "attach_bonded"):
                out = list(fx.attach_bonded(self, out))
        self._bonded_dev = tuple(out)

    def _setup_alive(self, style, tuples):
        """The breakable style's alive flags, one per tuple: all alive at
        the first set-up, kept over later ones (tpumd/md/simulation.py:
        519-540)."""
        if style.alive is None or style.alive.shape[0] != tuples.shape[0] \
                or style.alive.device != tuples.device:
            style.alive = torch.ones(tuples.shape[0], dtype=torch.bool,
                                     device=self.device)
        if not any(getattr(fx, "name", "") == "bond_break"
                   for fx in self.fixes):
            self.fixes.append(FixBondBreak())

    def _setup_special(self):
        """Per-row special lists for a grid sweep that weighs the special
        pairs (B5, B1-special; not beside FENE in B2, whose partners ride
        the state apart) or the matrix engine's special codes: entries
        whose lj and coul weights are both 1 are dropped
        (tpumd/md/simulation.py:469-491), and the lists follow the rows by
        tag.  A fix that enters special entries on the
        card (bond/create) gets its ``special_room`` of empty columns."""
        room = max([fx.special_room(self) for fx in self.fixes
                    if hasattr(fx, "special_room")], default=0)
        if room and self.special_tags is None:
            self.special_tags = np.zeros((self.natoms, 1), np.int32)
            self.special_codes = np.zeros((self.natoms, 1), np.int32)
        self._special_width = None
        fene = any(st.kernel_bond for k, st in self.bonded.items()
                   if self.topology.get(k) is not None
                   and len(self.topology[k]))
        if self.special_tags is None or not (
                self._mode == "matrix"
                or (self._grid_weighs_special() and not fene)):
            return
        st, sc = self._special_rows(self.state, self.special_tags,
                                    self.special_codes)
        self._special_width = st.shape[1] + room
        self.state = self._with_special(self.state, st, sc)

    def _special_rows(self, s, tags, codes):
        """The kept entries of tag-indexed special lists (host arrays),
        packed to the front, in the rows of state s: (st, sc) numpy."""
        slj, scl = self._special_weights()
        st = np.asarray(tags, np.int32)
        sc = np.asarray(codes, np.int32)
        keep = (st > 0) & ((np.asarray(slj)[sc] != 1.0)
                           | (np.asarray(scl)[sc] != 1.0))
        smax = max(int(keep.sum(1).max()), 1)
        order = np.argsort(~keep, axis=1, kind="stable")[:, :smax]
        kept = np.take_along_axis(keep, order, 1)
        st = np.take_along_axis(st, order, 1) * kept
        sc = np.take_along_axis(sc, order, 1) * kept
        rows = np.maximum(s.tag.cpu().numpy() - 1, 0)
        live = (s.tag.cpu().numpy() > 0)[:, None]
        return st[rows] * live, sc[rows] * live

    def _with_special(self, s, st, sc):
        """s with special lists st, sc padded to the set-up's width."""
        width = self._special_width or st.shape[1]
        if st.shape[1] > width:
            raise RuntimeError(
                f"special lists of {st.shape[1]} entries past the room of "
                f"{width} (raise extra/special/per/atom)")
        pad = ((0, 0), (0, width - st.shape[1]))
        return s.replace(
            special_tags=torch.as_tensor(np.pad(st, pad), device=self.device),
            special_codes=torch.as_tensor(np.pad(sc, pad),
                                          device=self.device))

    def refresh_special(self):
        """The special lists rebuilt from the live bonds on the host
        during a run (after fix bond/create or bond/break), written into
        the running state, and the neighbor matrix rebuilt so that its
        special codes follow."""
        bonds = self.live_topology("bond")
        self.special_tags, self.special_codes = build_special(
            self.natoms, np.zeros((0, 3), np.int64) if bonds is None
            else bonds)
        s, neigh, fstates = self._carry
        st, sc = self._special_rows(s, self.special_tags, self.special_codes)
        s, neigh = rebuild_now(self._with_special(s, st, sc), neigh,
                               self._ctx)
        self._carry = (s, neigh, fstates)
        self.state = s

    def _sort_atoms_host(self):
        """Spatial sort at setup (Atom::sort, src/atom.cpp:2246): fixes the
        atom order the grid binning starts from."""
        cutneigh = self.max_cutoff() + self.skin
        if cutneigh <= 0:
            return
        binsize = 0.5 * cutneigh
        s = self.state
        x = s.x.detach().cpu().numpy().astype(np.float64)
        lo = s.box.lo.cpu().numpy().astype(np.float64)
        hi = s.box.hi.cpu().numpy().astype(np.float64)
        ell = hi - lo
        nbin = np.maximum((ell / binsize).astype(int), 1)
        bininv = nbin / ell
        c = np.clip(((x - lo) * bininv).astype(int), 0, nbin - 1)
        ibin = (c[:, 2] * nbin[1] + c[:, 1]) * nbin[0] + c[:, 0]
        perm = np.argsort(ibin, kind="stable")
        if np.array_equal(perm, np.arange(len(perm))):
            return
        pj = torch.as_tensor(perm, device=self.device)
        self.state = map_per_atom(s, lambda a: a[pj])

    def _grid_setup(self, s: MDState, nbuilds: int = 1):
        """Pad, bin and permute a compact state into a fresh grid
        (for the current config) and build its pair list where the style
        sweeps one; returns (state, neigh).  A granular style's history
        tables come from the contact history the state carries by tag
        (``_pop_history``), moved with the atoms; zero without one."""
        cfg = self._neigh_cfg      # the whole grid, where it is decomposed
        self.grid_setups += 1
        s = cg.pad_state(wrap_pbc(s), cfg.capacity)
        valid0 = torch.arange(s.capacity, device=self.device) < self.natoms
        perm, valid, max_count, over = cg.bin_permutation(
            s.x, valid0, s.box, cfg)
        s, history = _pop_history(cg.apply_permutation(s, perm, valid))
        tables = {}
        if self.granular:
            tables = {"shear_tags": torch.zeros(
                (cfg.capacity, KH), dtype=torch.int32, device=self.device),
                "shear": torch.zeros((cfg.capacity, KH, 3),
                                     dtype=self.dtype, device=self.device)}
            if history is not None:
                # the first KH live entries of each row
                ptags, shear = history
                order = torch.argsort((ptags == 0).to(torch.int8), dim=1,
                                      stable=True)[:, :KH]
                w = order.shape[1]
                tables["shear_tags"][:, :w] = torch.gather(ptags, 1, order)
                tables["shear"][:, :w] = torch.gather(
                    shear, 1, order[..., None].expand(-1, -1, 3)).to(
                        self.dtype)
        owned = None
        rows = cg.row2slot_from_tags(s.tag, self.natoms)
        if self._ctx.decomp is not None:
            # every rank binned the whole system alike; it keeps its brick
            s, valid, owned = self._ctx.decomp.shard(s, valid)
            rows = torch.nonzero(owned).reshape(-1)
        plist, list_over = grid_pairlist(s, valid, self._ctx)
        if list_over is not None:
            over = over | list_over
        neigh = cg.CellGridState(
            valid=valid, xhold=s.x, ago=0, nbuilds=nbuilds, overflow=over,
            max_count=max_count, row2slot=rows, owned=owned, **tables,
            **plist)
        return s, neigh

    def _check_engine(self, mode: str):
        """Raise on what the chosen engine cannot take.  PPPM needs a
        periodic box on either engine.  On the cell grid, the B1-B5
        kernels take neither a non-periodic axis nor neigh_modify exclude
        group (only the granular sweep holds the group bits), and no
        kernel takes a triclinic box.  On a triclinic box the barostat
        is fix nh's, which carries the tilt factors; rigid/npt and
        rigid/nph dilate the lengths alone, and a shrink-wrapped face
        would be set in x, not in lamda coordinates, so both raise.  On the
        cell grid a bonded deck that its kernels cannot take
        (``_grid_refusal``) raises and names the matrix engine.  On the
        matrix engine, a pair style whose matrix path is not ported
        raises, naming itself; it takes kspace, the bonded styles and
        SHAKE beside any pairwise style."""
        name = getattr(self.pair, "name", None)
        box = self.state.box
        if self.kspace is not None and not all(box.periodic):
            raise NotImplementedError(
                f"boundary {' '.join(self.boundary)} with pair_style {name}"
                f" and kspace_style {self.kspace.style}: a non-periodic "
                "axis is ported without kspace only")
        if self.kspace is not None and box.istriclinic:
            raise NotImplementedError(
                f"kspace_style {self.kspace.style} on a triclinic box is "
                "not ported")
        rigid_baro = [fx.name for fx in self.fixes
                      if fx.box_change and fx.name.startswith("rigid")]
        if box.istriclinic and rigid_baro:
            raise NotImplementedError(
                f"fix {rigid_baro[0]} on a triclinic box: it dilates the "
                "box lengths and leaves the tilt factors behind, as tpumd "
                "does (fix npt/nph carry them)")
        shrunk = [a for a, tok in zip("xyz", self.boundary)
                  if set(tok) & set("sm")]
        if box.istriclinic and shrunk:
            raise NotImplementedError(
                f"boundary {' '.join(self.boundary)} on a triclinic box: a "
                f"shrink-wrapped {'/'.join(shrunk)} face would be set from "
                "the atoms' extent in x, not in lamda coordinates (not "
                "ported)")
        if mode == "cellgrid":
            refusal = self._grid_refusal()
            if refusal is not None:
                raise NotImplementedError(
                    f"{refusal} (neighbor_mode cellgrid; the matrix engine "
                    "takes the deck)")
            if self.pair is not None and not self.pair.supports_cellgrid:
                raise NotImplementedError(
                    f"pair_style {name} on the cell grid is not ported (the "
                    "matrix engine takes it)")
            if not all(box.periodic) and not self.granular:
                raise NotImplementedError(
                    f"boundary {' '.join(self.boundary)} with pair_style "
                    f"{name} on the cell grid: a non-periodic axis is "
                    "ported there for granular pair styles only (the "
                    "matrix engine takes it)")
            if self.neigh_exclude and not self.granular:
                raise NotImplementedError(
                    f"neigh_modify exclude group with pair_style {name} on "
                    "the cell grid: it is ported there for granular pair "
                    "styles only, whose sweep holds the group bits (the "
                    "matrix engine takes it)")
            if box.istriclinic:
                raise NotImplementedError(
                    "a triclinic box on the cell grid: the matrix engine "
                    "takes it")
            return
        if self.pair is not None and not self.pair.matrix_engine:
            raise NotImplementedError(
                f"pair_style {name} on the matrix neighbor engine is not "
                "ported")

    def setup(self):
        """Initial neighbor build + force evaluation (Verlet::setup)."""
        self._mass_sum = None
        if self.state.peratom:
            # the per-atom tables of fixes that are gone go with them
            keep = {fx.history_key for fx in self.fixes
                    if hasattr(fx, "history_key")} | set(PAIR_HISTORY)
            self.state = self.state.replace(peratom={
                k: a for k, a in self.state.peratom.items() if k in keep})
        if self._shrink_small is None:
            self._shrink_small = SMALL * self.state.box.lengths_np()
        self._reset_box_host()
        if self.pair is not None:
            self.pair.init()
            if self.pair.tail_flag:
                if not hasattr(self.pair, "compute_tails"):
                    raise NotImplementedError(
                        f"pair_modify tail yes with pair_style "
                        f"{self.pair.name} is not ported (lj/cut has tail "
                        "terms)")
                typ = self.state.type.cpu().numpy()
                counts = np.bincount(typ, minlength=self.ntypes + 1)
                self.pair.compute_tails(counts.astype(np.float64))
        if self.granular:
            self._setup_granular()
        self._mode = self._resolve_mode()
        self._check_engine(self._mode)
        if self.mesh.distributed:
            self._check_decomposable()
            # counted on the whole system before it is split
            self.natoms
            self._mass_sum = self._masses(self.state)
        for fx in self.fixes:
            if getattr(fx, "name", "") == "nh" and fx.groupbit != 1:
                # a thermostat on a group counts the group's dof
                # (tpumd/md/simulation.py:459-464)
                n = int(((self.state.gmask & fx.groupbit) > 0).sum())
                fx.group_tdof = float(self.dimension * (n - 1))
        self._sort_atoms_host()
        # reference row order (post-sort, pre-grid-permutation): host RNG
        # streams draw in this order and are re-indexed by tag
        self._ref_order_tags = self.state.tag.cpu().numpy()
        # a fix that made or broke bonds hands its rows to the topology
        # first; the special lists follow it
        if any([fx.fold_topology(self) for fx in self.fixes
                if hasattr(fx, "fold_topology")]):
            bonds = self.topology.get("bond")
            self.special_tags, self.special_codes = (
                (None, None) if bonds is None or not len(bonds)
                else build_special(self.natoms, bonds))
        self._setup_special()
        # SHAKE first: its constrained bonds and angles leave the bonded
        # styles (the reference negates their types)
        excl = self.build_shake()
        self._setup_bonded(excl)
        self._setup_kernel_bond()
        self._setup_grid_tuples(excl)
        if getattr(self.pair, "is_tip4p", False):
            # alpha and each O's two H by tag (tpumd/md/simulation.py:
            # 597-604 resolves rows)
            by_tag = np.zeros(self.natoms + 1, np.int64)
            by_tag[self.state.tag.cpu().numpy()] = \
                self.state.type.cpu().numpy()
            self.pair.setup_tip4p(self.bonded, self.topology.get("bond"),
                                  by_tag, self.device)
        if self.kspace is not None:
            self._setup_kspace()
        for _ in range(6):
            self._ctx = self._make_ctx()
            if self._mode == "cellgrid":
                s, neigh = self._grid_setup(self.state)
                if not self._agreed(neigh.overflow):
                    break
                # grow the capacity that overflowed, retry
                self._grow_grid(neigh, neigh.max_count)
                continue
            s, neigh = self._matrix_setup(self.state)
            if self._agreed(neigh.overflow):
                self._grow_matrix(neigh)
                continue
            if self._kmax_override is None:
                # shrink K once to the observed largest count (+3, a
                # multiple of 8): every pair sweep walks all K slots
                # (tpumd/md/simulation.py:674-689)
                tight = int(np.ceil((self._agreed(neigh.max_count) + 3)
                                    / 8) * 8)
                if tight + 4 <= self._neigh_cfg.kmax:
                    self._kmax_override = tight
                    continue
            break
        self._check_overflow(neigh)
        ctx = self._ctx
        f, energies, virial, torque, _ = eval_energies(s, neigh, ctx)
        s = s.replace(f=f) if torque is None else s.replace(f=f,
                                                            torque=torque)
        fstates = []
        # the reference applies post_force fixes once in setup
        # (Verlet::setup -> modify->setup): langevin kicks the step-0
        # forces and uses up RNG draws; SHAKE corrects the coordinates
        for fx in self.fixes:
            fs = self._fstate_stash.pop(id(fx), None)
            if fs is None:
                fs = fx.init_state(s, ctx)
                saved = self.restart_fstates.pop(getattr(fx, "id", None),
                                                 None)
                if saved is not None and saved[0] == fx.name:
                    # a restart file's fix nvt/npt/nph state
                    from tpumd_torch.io.restart import restore_leaves
                    fs = restore_leaves(fs, saved[1])
            xin = fx.segment_inputs(1, ctx, s)
            s, fs = fx.setup_post_force(s, fs, ctx,
                                        None if xin is None else xin[0])
            if fx.contributes_virial:
                virial = virial + fx.virial_contrib(fs)
            fstates.append(fs)
        if ctx.tdof != self.dof():
            # a rigid fix counts its bodies' dof at its set-up
            ctx = self._ctx = dataclasses.replace(ctx, tdof=self.dof())
        if ctx.respa is not None:
            # every level's forces with the fixes' hooks (Respa::setup)
            if getattr(self.pair, "is_tip4p", False) or self.granular:
                raise NotImplementedError(
                    f"run_style respa with pair_style {self.pair.name} is "
                    "not ported")
            s, fstates = respa_forces(s, neigh, ctx, fstates)
            fstates = list(fstates)
        fstates = [fx.save_virial(fs, virial) if fx.needs_virial else fs
                   for fx, fs in zip(self.fixes, fstates)]
        # a rigid barostat's set-up reads the state with the saved virial
        # (FixRigidNH::setup's tail)
        fstates = [fx.setup_with_state_virial(s, fs, ctx)
                   if hasattr(fx, "setup_with_state_virial") else fs
                   for fx, fs in zip(self.fixes, fstates)]
        self._carry = (s, neigh, tuple(fstates))
        self.state = s
        self._last_energies = energies
        self._last_virial = virial
        self._energies_of = s
        for c in self.computes.values():
            c.setup(self)

    def _setup_kspace(self):
        """Couple kspace to the pair style: a style with a real-space
        Ewald part (g_ewald) or MSM's taper (msm_order) and a Coulomb
        cutoff, beside charges; every kspace style takes the one interface
        init(natoms, q, prd, units, cutoff, dynamic_box, types, pair)
        (tpumd/models/kspace_pppm.py:161-186), and the pair style then
        takes its g_ewald and, for the dispersion solvers, g_ewald_6 (MSM
        sets its cutoff itself).  A TIP4P style needs pppm/tip4p, whose
        sites it hands over."""
        ks, pair = self.kspace, self.pair
        need = getattr(ks, "pair_needs", "g_ewald")
        if self.state.q is None or not (hasattr(pair, need)
                                        and hasattr(pair, "cut_coul")):
            raise NotImplementedError(
                f"kspace_style {ks.style} needs charges and a pair style "
                f"with {'a coul/long' if need == 'g_ewald' else 'its'} "
                "real-space part, not pair_style "
                f"{getattr(pair, 'name', None)}")
        if getattr(pair, "is_tip4p", False) and ks.style != "pppm/tip4p":
            raise NotImplementedError(
                f"pair_style {pair.name} with kspace_style {ks.style}: the "
                "TIP4P sites take kspace_style pppm/tip4p")
        ks.init(self.natoms, self.state.q.cpu().numpy(),
                self.state.box.lengths_np(), self.units, pair.cut_coul,
                dynamic_box=self._barostat_active(),
                types=self.state.type.cpu().numpy(), pair=pair)
        if self.mesh.distributed:
            # pppm's mesh summed over the ranks (_check_decomposable lets
            # no other style through)
            ks.mesh = self.mesh
        for name in ("g_ewald", "g_ewald_6"):
            if hasattr(ks, name) and hasattr(pair, name):
                setattr(pair, name, getattr(ks, name))

    def current_energies(self):
        """(energies, virial) of the current state: the last thermo or
        set-up evaluation's, else a new one (the fixes' virial added, as on
        a thermo step)."""
        s, neigh, fstates = self._carry
        if self._energies_of is not s:
            _, self._last_energies, virial, _, _ = eval_energies(
                s, neigh, self._ctx)
            for fx, fs in zip(self.fixes, fstates):
                if fx.contributes_virial:
                    virial = virial + fx.virial_contrib(fs)
            self._last_virial = virial
            self._energies_of = s
        return self._last_energies, self._last_virial

    def _matrix_setup(self, s: MDState, nbuilds: int = 1, old=None):
        """Wrap a compact state and build its neighbor matrix (for the
        current config); returns (state, neigh).  A granular style's
        history is carried from ``old`` by j-match, or from the contact
        history the state carries by tag (``_pop_history``), else zero."""
        s, history = _pop_history(wrap_pbc(s))
        if self._ctx.decomp is not None:
            s = self._ctx.decomp.shard(s)[0]
        neigh = build_matrix(s, self._ctx, nbuilds, old=old,
                             history=self.granular and self.pair.has_history)
        if old is None and history is not None and neigh.shear is not None:
            neigh = neigh.replace(shear=remap_history_by_tag(
                history[0], history[1].to(self.dtype),
                partner_tags(s.tag, neigh.idx)))
        return s, neigh

    def _grow_matrix(self, neigh):
        """Grow both matrix capacities after an overflow (the flag is the
        cell cap's or K's; tpumd/md/simulation.py:1393-1405)."""
        mc = self._agreed(neigh.max_count)
        self._kmax_override = int(max(self._neigh_cfg.kmax * 1.5, mc * 1.3)
                                  + 8)
        self._cellcap_override = int(np.ceil(
            self._neigh_cfg.cell_cap * 1.5 / 8) * 8)

    def _setup_granular(self):
        """A granular style needs sphere atoms, the frozen group's bit for
        its effective-mass rule (PairGranHookeHistory::init_style finds fix
        freeze), the excluded group-bit pairs and the largest radius for
        its cutoff."""
        if self.state.radius is None:
            raise ValueError(f"pair_style {self.pair.name} needs atom_style "
                             "sphere")
        for fx in self.fixes:
            if getattr(fx, "name", "") == "freeze":
                self.pair.freeze_group_bit = fx.groupbit
        self.pair.exclude_bits = self.neigh_exclude
        self.pair.set_max_radius(float(self.state.radius.max()))

    def invalidate_ctx(self):
        """Force a re-setup before the next run (the fix set changed);
        the padded grid-ordered state goes back to natoms rows."""
        if self._carry is not None:
            s, neigh, fstates = self._carry
            if self._ctx.is_cellgrid:
                self._refreshes += self._grid_refreshes(neigh)
            # fixes that survive keep their state across the re-setup (an
            # unfixed or replaced fix's goes: its id() may be reused)
            self._fstate_stash = {
                id(fx): fs for fx, fs in zip(self._ctx.fixes, fstates)
                if any(fx is kept for kept in self.fixes)}
            s = self._push_history(s, neigh)
            if self._ctx.decomp is not None:
                self.state = self._ctx.decomp.unshard(s, neigh)
            else:
                self.state = (cg.compact_state(s, neigh.valid, self.natoms)
                              if self._ctx.is_cellgrid else s)
        self._ctx = None
        self._carry = None

    def _push_history(self, s: MDState, neigh) -> MDState:
        """s with the granular contact history of neigh in its per-atom
        tables, as each atom's partner tags (0: none) and shears, so that
        it follows the atoms by tag through compaction, sorting and
        insertion to the next set-up (tpumd's _shear_stash, kept by tag)."""
        shear = getattr(neigh, "shear", None)
        if shear is None:
            return s
        ptags = (neigh.shear_tags if self._ctx.is_cellgrid
                 else partner_tags(s.tag, neigh.idx))
        return s.replace(peratom={**(s.peratom or {}),
                                  PAIR_HISTORY[0]: ptags,
                                  PAIR_HISTORY[1]: shear})

    def _grow_grid(self, neigh, max_count):
        """Grow the cell grid's capacities after an overflow that the grid
        state neigh shows: K of the pair list from its longest row where
        that passed K, and unless only the list overflowed, the cell
        capacity from max_count (tpumd/md/simulation.py:1376-1405)."""
        cfg, k = self._neigh_cfg, self._ctx.pairlist_k
        longest = (None if neigh.max_pairs is None
                   else self._agreed(neigh.max_pairs))
        if longest is not None and longest > k:
            self._kmax_override = int(np.ceil(max(
                k * 1.5, longest * 1.3) / 8) * 8)
            if self._agreed(neigh.max_count) <= cfg.cap:
                return
        self._cap_override = int(np.ceil(max(
            cfg.cap * 1.5, self._agreed(max_count) * 1.3) / 8) * 8)

    def _agreed(self, value) -> int:
        """An int or a () tensor on the host, the largest over the ranks
        where the run is decomposed: every rank then takes the same
        decision."""
        if self.mesh.distributed:
            return self.mesh.agree_max(value)
        return int(value)

    @property
    def decomposed(self) -> bool:
        """Whether the set-up runs decomposed over the process group."""
        return self._ctx is not None and self._ctx.decomp is not None

    def _check_decomposable(self):
        """Raise on what a run across ranks does not take yet, naming the
        ROADMAP item that ports it: 14d, the thermostats and barostats
        (every fix but nve and shake); 14e, the rest (hybrid and FENE
        bonds on the grid, fix rattle and the rigid fixes, kspace styles
        but pppm, computes, granular and the grid's pair styles past B1,
        B3/B4 and B5, the matrix engine's past the plain pairwise sweep,
        shrink-wrapped faces, triclinic boxes, neigh_modify exclude,
        respa, dumps but atom and custom).  The molecular stack runs:
        bonded styles, special bonds, fix shake, pppm and
        lj/charmm/coul/long on the grid, charged pairwise styles on the
        matrix engine."""
        from tpumd_torch.md.fix_shake import FixShake
        from tpumd_torch.md.fixes import FixNVE
        from tpumd_torch.models.base import PairStyle
        from tpumd_torch.models.kspace_pppm import PPPM

        def refuse(what, item="14e"):
            raise NotImplementedError(
                f"{what} across {self.mesh.size} ranks is not ported "
                f"(ROADMAP item {item}): run it on one card")
        name = getattr(self.pair, "name", None)
        for kind, style in self.bonded.items():
            if style.name == "hybrid" or style.breakable:
                refuse(f"{kind}_style {style.name}")
            if style.kernel_bond and self._mode == "cellgrid":
                refuse(f"{kind}_style {style.name} on the cell grid")
        for fx in self.fixes:
            if type(fx) in (FixShake, FixNVE):
                continue
            fname = getattr(fx, "name", type(fx).__name__)
            if fname == "nh":
                fname = ("npt" if fx.tstat else "nph") if fx.pstat else "nvt"
            refuse(f"fix {getattr(fx, 'id', '')} {fname}",
                   "14d" if fname in ("nvt", "npt", "nph", "langevin")
                   else "14e")
        if self.kspace is not None and type(self.kspace) is not PPPM:
            refuse(f"kspace_style {self.kspace.style}")
        for cid, c in self.computes.items():
            refuse(f"compute {cid} {getattr(c, 'style', type(c).__name__)}")
        if self.respa is not None:
            refuse("run_style respa")
        if self.granular:
            refuse(f"pair_style {name}")
        if any(set(tok) & set("sm") for tok in self.boundary):
            refuse(f"boundary {' '.join(self.boundary)} (shrink-wrapped)")
        if self.state.box.istriclinic:
            refuse("a triclinic box")
        if self.neigh_exclude:
            refuse("neigh_modify exclude")
        if self.pair is None:
            refuse("a run without a pair style")
        if self._mode == "cellgrid":
            if not (getattr(self.pair, "charged", False)
                    or hasattr(self.pair, "compute_cellgrid")):
                refuse(f"pair_style {name} on the cell grid")
        elif (type(self.pair).compute is not PairStyle.compute
              or getattr(self.pair, "needs_velocities", False)
              or getattr(self.pair, "is_tip4p", False)):
            refuse(f"pair_style {name} on the matrix engine")
        for d in self.dumps:
            if d.style not in ("atom", "custom"):
                refuse(f"dump {d.id} {d.style}")

    def _check_overflow(self, neigh):
        if self._agreed(neigh.overflow):
            longest = ("" if getattr(neigh, "max_pairs", None) is None
                       else f" max_pairs={int(neigh.max_pairs)}")
            raise RuntimeError(
                f"neighbor overflow: max_count={int(neigh.max_count)}"
                f"{longest} cfg={self._neigh_cfg}")

    # ------------------------------------------------------------------ run
    def run(self, nsteps: int):
        """Run nsteps in segments that end at thermo and dump steps (the
        reference's Output::next, src/output.cpp); the device is read once
        a segment, and the energies are evaluated only where a thermo row
        prints.  A fix with a ``host_every`` also ends a segment at its
        steps, where its ``host_end_of_step`` may edit the atoms (insert or
        delete them) after invalidating the set-up, before the step's
        thermo and dumps; the next segment then starts from a new set-up,
        the contact and per-atom fix histories carried by tag
        (tpumd/md/simulation.py:834-1000).  ``host_run_begin`` runs before
        the run's set-up."""
        for fx in self.fixes:
            if hasattr(fx, "host_run_begin"):
                fx.host_run_begin(self)
        if self._ctx is None:
            self.setup()
        ctx = self._ctx
        self._thermo_header()
        self._thermo_line()  # setup thermo at current step
        self._write_dumps(setup=True)
        self._setup_output_fixes()
        target = self.step + nsteps
        s0, neigh0, fstates0 = self._carry
        self._carry = (s0, neigh0, tuple(
            fx.pre_run(fs, self.step, target) if hasattr(fx, "pre_run")
            else fs for fx, fs in zip(self.fixes, fstates0)))
        for fx in self.fixes:
            if hasattr(fx, "host_run_start"):
                # fix external: the caller's force buffer, or its callback
                # at the set-up step
                fx.host_run_start(self)
        t0 = time.perf_counter()
        if self._wall_start is None:
            self._wall_start = t0
        self.halt = None
        while self.step < target:
            nxt = target
            for every in ([self.thermo_every] + [d.every for d in self.dumps]
                          + [fx.host_every for fx in self.fixes]):
                if every > 0:
                    nxt = min(nxt, (self.step // every + 1) * every)
            seg = nxt - self.step
            xs = [fx.segment_inputs(seg, ctx, self._carry[0])
                  for fx in self.fixes]
            while True:
                snapshot = self._carry
                # a redone segment reuses the same host draws
                carry, mid = self._advance(snapshot, ctx, seg, xs)
                # the one overflow read of the segment
                over, lost = self._segment_flags(carry)
                if lost and not self._hist_warned:
                    self._hist_warned = True
                    self._log(f"WARNING: a sphere touched {lost} others "
                              f"\u2014 contacts beyond {KH} per atom lose "
                              f"shear history")
                if over:
                    # grow capacities, redo the segment from the snapshot
                    self.steps_redone += seg
                    ctx = self._regrow(snapshot, carry[1])
                    continue
                break
            self._carry = carry
            self.step = nxt
            if self._barostat_active() or ctx.shrink:
                ctx = self._revalidate_geometry()
            self.state = self._carry[0]
            if mid is not None:
                # thermo reads the last force evaluation's energies and
                # virial, taken before the end-of-step box move
                self._last_energies, virial = mid
                for fx, fs in zip(self.fixes, self._carry[2]):
                    if fx.contributes_virial:
                        virial = virial + fx.virial_contrib(fs)
                self._last_virial = virial
                self._energies_of = self._carry[0]
            for fx in self.fixes:
                if fx.host_every and self.step % fx.host_every == 0:
                    fx.host_end_of_step(self)
            if self._ctx is None:
                # a host fix edited the atoms: set up anew
                self.setup()
                ctx = self._ctx
            self.state = self._carry[0]
            if self.step == target or (self.thermo_every > 0 and
                                       self.step % self.thermo_every == 0):
                # carry keeps the in-step f; thermo's energies and virial
                # are evaluated once per state (current_energies)
                self._thermo_line()
            self._write_dumps()
            if self.halt:
                self._log(self.halt)
                nsteps -= target - self.step
                break
            if self.timer_timeout is not None and self._agreed(
                    time.perf_counter() - self._wall_start
                    > self.timer_timeout):
                self._log("Wall time limit reached")
                nsteps -= target - self.step
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.loop_time += elapsed
        self.loop_steps += nsteps
        if self.decomposed:
            # host commands after the run see the whole system, in the
            # one-card grid's order; the next run goes on from the carry
            self.state = self._ctx.decomp.unshard(*self._carry[:2])
        self._finish_report(elapsed, nsteps)

    def minimize(self, etol: float, ftol: float, maxiter: int,
                 maxeval: int) -> bool:
        """The minimize command (tpumd/md/simulation.py:1242-1260): a
        thermo row before and after, and the line ``Minimization:
        converged|max iterations after N iterations, E e0 -> e1``, with the
        style of ``min_style`` (md/minimize.py); the timestep stays."""
        from tpumd_torch.md.minimize import minimize
        if self._ctx is None:
            self.setup()
        self._thermo_header()
        self._thermo_line()
        conv, niter, e0, e1 = minimize(self, self.min_style, etol, ftol,
                                       maxiter, maxeval)
        self._thermo_line()
        self._log(f"Minimization: {'converged' if conv else 'max iterations'}"
                  f" after {niter} iterations, E {e0:.10g} -> {e1:.10g}")
        return conv

    def _advance(self, carry, ctx, seg: int, xs):
        """Run seg steps from carry; returns (carry, None), or where a fix
        moves the box at end_of_step, (carry, (energies, virial) of the
        last step's force evaluation), that step split around it
        (tpumd/md/simulation.py:901-941).  A step where a fix's host
        callback is due (fix external pf/callback) is split too, the
        callback run between its force evaluation and post_force
        (tpumd/md/simulation.py:1263-1298)."""
        eos = any(fx.eos_box_change for fx in self.fixes)
        mids = [fx for fx in self.fixes if hasattr(fx, "mid_step_due")]

        def split(k):
            istep = self.step + k + 1
            return (eos and k == seg - 1) or any(fx.mid_step_due(istep)
                                                 for fx in mids)
        if not eos and not any(split(k) for k in range(seg)):
            return run_segment(*carry, ctx, seg, xs, step0=self.step), None
        mid, k = None, 0
        while k < seg:
            if not split(k):
                end = next((j for j in range(k, seg) if split(j)), seg)
                carry = run_segment(*carry, ctx, end - k, [
                    None if x is None else x[k:end] for x in xs],
                    step0=self.step + k)
                k = end
                continue
            istep = self.step + k + 1
            now = [None if x is None else x[k] for x in xs]
            s, neigh, fstates, virial = step_pre(*carry, ctx, istep, now)
            if eos and k == seg - 1:
                _, energies, vmid, _, _ = eval_energies(s, neigh, ctx)
                mid = (energies, vmid)
            carry = (s, neigh, fstates)
            for fx in mids:
                if fx.mid_step_due(istep):
                    carry = fx.invoke_callback(self, carry, istep)
            carry = step_post(*carry, ctx, now, virial)
            k += 1
        return carry, mid

    def recompute_output(self):
        """The forces, energies and virial of the carried state anew, with
        no fix's post_force (tpumd/md/simulation.py:1432-1448), after a
        replica command left a stored configuration in the carry."""
        if self._ctx is None:
            return
        s, neigh, fstates = self._carry
        f, energies, virial, torque, _ = eval_energies(s, neigh, self._ctx)
        s = s.replace(f=f) if torque is None else s.replace(f=f,
                                                            torque=torque)
        for fx, fs in zip(self.fixes, fstates):
            if fx.contributes_virial:
                virial = virial + fx.virial_contrib(fs)
        self._carry = (s, neigh, fstates)
        self.state = s
        self._last_energies, self._last_virial = energies, virial
        self._energies_of = s

    def _setup_output_fixes(self):
        """At a run's set-up, after its thermo row and dumps: an ave fix
        whose window is one sample samples and writes when the run starts
        on one of its output steps (FixAveTime::setup -> end_of_step), once;
        fix ave/correlate takes its set-up sample (tpumd/md/simulation.py:
        848-864)."""
        for fx in self.fixes:
            if getattr(fx, "invoke_at_setup", False) and fx.nfreq \
                    and fx.nrepeat == 1 and self.step % fx.nfreq == 0 \
                    and not fx._setup_invoked:
                fx.host_end_of_step(self)
                fx._setup_invoked = True
            if hasattr(fx, "host_setup_sample") and not fx._setup_sampled:
                fx.host_setup_sample(self)
                fx._setup_sampled = True

    def _write_dumps(self, setup: bool = False):
        due = [d for d in self.dumps if d.due(self.step, setup)]
        if not due:
            return
        if not self.decomposed:
            for d in due:
                d.write(self)
            return
        # every rank's atoms gathered; rank 0 writes the snapshot
        here = self.state
        self.state = self._ctx.decomp.unshard(*self._carry[:2])
        try:
            for d in due:
                if self.mesh.rank == 0:
                    d.write(self)
                else:
                    d.last_step = self.step
        finally:
            self.state = here

    def _segment_flags(self, carry) -> tuple[bool, int]:
        """(cell or list overflow, the pair's hist_over: the largest
        contact count of a sphere that had more than KH on the grid, else
        0), read from the device in one transfer, with the error flags
        that fixes keep on the device (``device_flags``) and the grid's
        lost-member flag of the tag-matched bonded path: a set one
        raises, naming the fix or the tuples."""
        neigh = carry[1]
        words = [torch.as_tensor(
            neigh.overflow if not self._ctx.is_cellgrid
            else neigh.any_overflow).reshape(1).to(torch.int64)]
        lost = getattr(self.pair, "hist_over", None)
        track = (self._ctx.is_cellgrid and neigh.shear_tags is not None
                 and lost is not None)
        if track:
            words.append(lost.reshape(-1).to(torch.int64))
        missing = getattr(neigh, "tuples_missing", None)
        if missing is not None:
            words.append(missing.reshape(1).to(torch.int64))
        flagged = [(fx, fx.device_flags(fs))
                   for fx, fs in zip(self._ctx.fixes, carry[2])
                   if hasattr(fx, "device_flags")]
        words += [f.reshape(1).to(torch.int64) for _, f in flagged]
        vals = (words[0] if len(words) == 1 else torch.cat(
            [w.to(words[0].device) for w in words]))
        # the ranks' flags, their largest: every rank redoes the segment
        vals = self.mesh.all_reduce(vals, "max").tolist()
        for (fx, _), bad in zip(flagged, vals[len(vals) - len(flagged):]):
            if bad:
                raise RuntimeError(f"fix {fx.id}: {fx.flag_message} at or "
                                   f"before step {self.step + 1}")
        if missing is not None and vals[1 + track]:
            from tpumd_torch.ops.cellgrid_tuples import missing_tuples
            lost_tuples = missing_tuples(carry[0], self._ctx, [
                st for st, _ in self._ctx.bonded])
            raise RuntimeError(
                f"bonded tuples lost a member at or before step "
                f"{self.step + 1}: {lost_tuples or 'on another rank'} (the "
                "tag-matched path finds members within one cell)")
        return bool(vals[0]), (vals[1] if track else 0)

    def _rebin(self, snapshot, check: bool = True):
        """Rebuild the neighbor config for the snapshot's box and capacity
        overrides, then re-bin the snapshot's atoms (and their contact
        history) into the grid, or rebuild their neighbor matrix
        (tpumd/md/simulation.py:1304-1374); returns the new context.  An
        overflow raises unless check is False (``rebin_grown``)."""
        s0, neigh0, fstates = snapshot
        decomp = self._ctx.decomp
        if self._ctx.is_cellgrid:
            self._refreshes += self._grid_refreshes(neigh0)
            self.state = (decomp.unshard(s0, neigh0)
                          if decomp is not None else
                          cg.compact_state(self._push_history(s0, neigh0),
                                           neigh0.valid, self.natoms))
            self._ctx = self._make_ctx()
            s, neigh = self._grid_setup(self.state, nbuilds=neigh0.nbuilds)
        else:
            # a decomposed matrix engine re-splits the gathered rows
            self.state = (s0 if decomp is None
                          else decomp.unshard(s0, neigh0))
            self._ctx = self._make_ctx()
            s, neigh = self._matrix_setup(
                self.state, nbuilds=neigh0.nbuilds,
                old=neigh0 if decomp is None else None)
        if check:
            self._check_overflow(neigh)
        self._carry = (s, neigh, fstates)
        return self._ctx

    def rebin_grown(self, snapshot):
        """_rebin(snapshot), the capacities grown until nothing overflows,
        as for a segment that overflowed (_regrow): a configuration the
        replica commands bring back (a swapped or stored replica) may crowd
        cells its own set-up did not."""
        for _ in range(8):
            self._rebin(snapshot, check=False)
            neigh = self._carry[1]
            over = (neigh.any_overflow if self._ctx.is_cellgrid
                    else neigh.overflow)
            if not self._agreed(over):
                return self._ctx
            if self._ctx.is_cellgrid:
                self._grow_grid(neigh, neigh.max_count)
            else:
                self._grow_matrix(neigh)
        self._check_overflow(self._carry[1])

    @staticmethod
    def _grid_refreshes(neigh) -> int:
        return 0 if neigh.list_hold is None else int(neigh.list_stat[2])

    @property
    def list_refreshes(self) -> int:
        """Pair list refreshes taken between re-bins since the set-up,
        those of segments redone after an overflow included (a read from
        the device)."""
        if self._carry is None or not self._ctx.is_cellgrid:
            return self._refreshes
        return self._refreshes + self._grid_refreshes(self._carry[1])

    def _regrow(self, snapshot, neigh):
        """Grow the cell capacity, or the pair list's K, (on the matrix
        engine K and the cell capacity) after an overflow that the
        segment's last neighbour state neigh shows, and rebuild from the
        snapshot (tpumd/md/simulation.py:1376-1405)."""
        if not self._ctx.is_cellgrid:
            self._grow_matrix(snapshot[1])
        else:
            self._grow_grid(neigh, snapshot[1].max_count)
        return self._rebin(snapshot)

    def _revalidate_geometry(self):
        """Re-check the cells against the box after a segment
        (tpumd/md/simulation.py:1412-1430), under a barostat or a
        shrink-wrapped face: the stencil misses pairs once a cell edge is
        shorter than cutneigh, so the grid is rebuilt, under a barostat
        with a 10 % wider margin.  On the matrix engine, the config is
        rebuilt also when the box needs other periodic images.  Returns
        the (possibly new) context."""
        if not self._ctx.is_cellgrid:
            if not nb.needs_new_config(self._carry[0].box, self._neigh_cfg):
                return self._ctx
            if self._barostat_active():
                self._baro_margin *= 1.10
            return self._rebin(self._carry)
        cutneigh = self.max_cutoff() + self.skin
        ell = self._carry[0].box.lengths_np()
        if (ell < 2.0 * cutneigh).any():
            raise RuntimeError(
                f"box shrank below 2*cutneigh at step {self.step}: "
                f"lengths {ell}, cutneigh {cutneigh:.4f}")
        cfg = self._neigh_cfg
        if (ell / np.array([cfg.nx, cfg.ny, cfg.nz]) < cutneigh).any():
            if self._barostat_active():
                self._baro_margin *= 1.10
            return self._rebin(self._carry)
        return self._ctx

    def _finish_report(self, elapsed: float, nsteps: int):
        """End-of-run report (Finish::end, src/finish.cpp:130-160)."""
        n = self.natoms
        ndev = (f"{self.mesh.size} devices" if self.mesh.distributed
                else "1 device")
        self._log(f"Loop time of {elapsed:.6g} on {ndev} "
                  f"for {nsteps} steps with {n} atoms")
        if elapsed > 0 and nsteps > 0:
            sps = nsteps / elapsed
            matom = sps * n / 1e6
            u = self.units
            if u.femtosecond > 0:
                # femtosecond is 1 fs in time units (1e-3 in metal's ps)
                perday = sps * self.dt / u.femtosecond * 1e-6 * 86400
                unit_day = f"{perday:.3f} ns/day"
            else:
                unit_day = f"{sps * self.dt * 86400:.3f} tau/day"
            self._log(f"Performance: {unit_day}, {sps:.3f} timesteps/s, "
                      f"{matom:.3f} Matom-step/s")
        self._log(f"Neighbor list builds = {self._carry[1].nbuilds - 1}")

    # ------------------------------------------------------------------ thermo
    def _thermo_computes(self) -> list[str]:
        """The thermo_style columns that read the deck's computes (c_ID,
        c_ID[i]), packed into the thermo row."""
        keys = [k for k in self.thermo_style if k.startswith("c_")
                and k[2:] not in THERMO_COMPUTES]
        for k in keys:
            if split_ref(k)[1] not in self.computes:
                raise ValueError(f"thermo_style {k}: no compute "
                                 f"{split_ref(k)[1]}")
        return keys

    def _thermo_fix_outputs(self):
        """(key, () tensor) of the thermo_style f_ID columns whose fix
        keeps its value on the device (``device_output``: the NEMD fixes),
        packed into the thermo row's one read."""
        out = []
        if self._carry is None:
            return out
        for k in self.thermo_style:
            if not k.startswith("f_") or "[" in k:
                continue
            for fx, fs in zip(self._ctx.fixes, self._carry[2]):
                if getattr(fx, "id", None) == k[2:] \
                        and hasattr(fx, "device_output") \
                        and fx.device_output(fs) is not None:
                    out.append((k, fx.device_output(fs)))
        return out

    def compute_entry(self, key):
        """() tensor of c_ID (the compute's scalar) or c_ID[i] (entry i of
        its global vector), unnormalized."""
        _, cid, col = split_ref(key)
        c = self.computes[cid]
        if col is None:
            return c.scalar_value(self)
        out = c(self)
        if out.dim() == 0:
            return c.vector_value(self)[col]
        if out.dim() != 1 or c.peratom:
            raise ValueError(f"{key}: compute {cid} ({c.style}) has no "
                             "global vector")
        return out[col]

    def _escaped(self, s):
        """() count of atoms outside a fixed (f) face, on the device
        (tpumd/md/simulation.py:1472-1500), or None without such a face."""
        valid = s.tag > 0
        out = None
        for d, tok in enumerate(self.boundary):
            for side, c in ((0, tok[0]), (1, tok[-1])):
                if c != "f":
                    continue
                past = (s.x[:, d] < s.box.lo[d] if side == 0
                        else s.x[:, d] > s.box.hi[d])
                n = torch.sum(past & valid)
                out = n if out is None else out + n
        return out

    def thermo_values(self) -> dict:
        s = self._carry[0]
        u = self.units
        energies, virial = self.current_energies()
        if self._ctx.decomp is not None:
            s = self._ctx.decomp.thermo_view(s, self._carry[1])
        extra = [self.compute_entry(k) for k in self._thermo_computes()]
        extra += [out for _, out in self._thermo_fix_outputs()]
        escaped = self._escaped(s)
        packed = pack_thermo(
            s, energies, virial,
            (self.dof(), u.boltz, u.mvv2e),
            torch.as_tensor(self.mass, dtype=self.dtype, device=self.device),
            extra + ([] if escaped is None else [escaped]))
        if self._ctx.decomp is not None:
            packed = self._reduce_thermo(packed)
        return self._vals_from_packed(
            packed.cpu().numpy().astype(np.float64))

    def _reduce_thermo(self, packed):
        """The thermo row of the whole system from each rank's row of its
        owned atoms: one float64 sum over the ranks of the partial sums
        (temperature, virial, atom count, energies, extras), the volume and
        box lengths rank 0's."""
        row = packed.to(torch.float64)
        if self.mesh.rank != 0:
            row = row.clone()
            row[[1, 4, 5, 6]] = 0.0
        return self.mesh.all_reduce(row, "sum")

    def _vals_from_packed(self, vals_h) -> dict:
        """Thermo dict from one pack_thermo row (Thermo::compute_*)."""
        u = self.units
        dof = self.dof()
        ncur = int(vals_h[3])
        if ncur != self.natoms:
            self._lost(f"Lost atoms: original {self.natoms} current {ncur} "
                       f"at step {self.step}")
        nenergy = 7 + len(ENERGY_KEYS)
        cids = self._thermo_computes()
        fouts = [k for k, _ in self._thermo_fix_outputs()]
        if len(vals_h) > nenergy + len(cids) + len(fouts) \
                and vals_h[-1] > 0:
            self._lost(f"Lost atoms: {int(vals_h[-1])} outside fixed "
                       f"boundaries at step {self.step}")
        if not np.isfinite(vals_h).all():
            raise RuntimeError(
                f"Non-finite thermodynamics at step {self.step} — "
                "simulation unstable")
        t, vol, vir3 = float(vals_h[0]), float(vals_h[1]), float(vals_h[2])
        ell = vals_h[4:7]
        e = dict(zip(ENERGY_KEYS, vals_h[7:nenergy].tolist()))
        ke = computes.kinetic_energy(t, dof, u.boltz)
        # long-range LJ tail corrections (Thermo::compute_evdwl,
        # ComputePressure: ptail/volume added to each diagonal term)
        etail = ptail = 0.0
        if self.pair is not None and self.pair.tail_flag:
            etail = self.pair.etail / vol
            ptail = self.dimension * self.pair.ptail / vol
        press = computes.pressure(t, vir3, vol, dof, u.boltz, u.nktv2p,
                                  ptail, self.dimension)
        epair = e["evdwl"] + etail + e["ecoul"] + e["elong"]
        emol = e["ebond"] + e["eangle"] + e["edihed"] + e["eimp"]
        pe = epair + emol
        norm = self.natoms if self.thermo_norm else 1
        if self._mass_sum is None:
            self._mass_sum = self._masses(self._carry[0])
        vals = {
            "step": self.step, "temp": t,
            "epair": epair / norm, "emol": emol / norm, "pe": pe / norm,
            "ke": ke / norm, "etotal": (pe + ke) / norm,
            "press": press, "vol": vol,
            "lx": float(ell[0]), "ly": float(ell[1]), "lz": float(ell[2]),
            "atoms": self.natoms,
            "density": self.units.mv2d * self._mass_sum / vol,
        }
        vals.update({k: e[k] / norm for k in ENERGY_KEYS})
        tilt = self._carry[0].box.tilt
        vals.update(zip(("xy", "xz", "yz"), (0.0,) * 3 if tilt is None
                        else tilt.detach().cpu().double().tolist()))
        for k, key in enumerate(cids):
            c = self.computes[split_ref(key)[1]]
            vals[key] = float(vals_h[nenergy + k]) / (
                norm if c.extensive else 1)
        for k, key in enumerate(fouts):
            vals[key] = float(vals_h[nenergy + len(cids) + k])
        self.last_thermo = vals
        return vals

    def _masses(self, s) -> float:
        """The summed mass of the atoms of s."""
        if s.rmass is not None:
            return float(s.rmass.double().sum())
        typ = s.type.cpu().numpy()
        return float(self.mass[typ[typ > 0]].sum())

    _THERMO_HEADERS = {
        "step": "Step", "temp": "Temp", "epair": "E_pair", "emol": "E_mol",
        "etotal": "TotEng", "press": "Press", "pe": "PotEng", "ke": "KinEng",
        "vol": "Volume",
    }

    def _lost(self, msg):
        """thermo_modify lost error (raise), warn (log a warning) or
        ignore (tpumd/md/simulation.py:1474-1495, Thermo::lost_check)."""
        if self.lost_policy == "error":
            raise RuntimeError(msg)
        if self.lost_policy == "warn":
            self._log("WARNING: " + msg)

    # thermo_style multi (src/thermo.cpp FORMAT_MULTI_HEADER; tpumd/md/
    # simulation.py:1573-1605): three "name = value" fields a line
    _MULTI_FIELDS = (
        ("TotEng", "etotal"), ("KinEng", "ke"), ("Temp", "temp"),
        ("PotEng", "pe"), ("E_bond", "ebond"), ("E_angle", "eangle"),
        ("E_dihed", "edihed"), ("E_impro", "eimp"), ("E_vdwl", "evdwl"),
        ("E_coul", "ecoul"), ("E_long", "elong"), ("Press", "press"))

    def _thermo_lines_multi(self, vals):
        cpu = (0.0 if self._wall_start is None
               else time.perf_counter() - self._wall_start)
        self._log(f"---------------- Step {self.step:8d} ----- "
                  f"CPU = {cpu:11.4f} (sec) ----------------")
        fields = list(self._MULTI_FIELDS)
        if self._barostat_active():
            fields.append(("Volume", "vol"))
        parts = []
        for i, (label, key) in enumerate(fields):
            parts.append(f"{label:<8} = {vals[key]:14.4f}")
            if (i + 1) % 3 == 0 or i == len(fields) - 1:
                self._log(" ".join(parts) + " ")
                parts = []

    def _thermo_header(self):
        if self.thermo_multi:
            return
        line = " ".join(self._THERMO_HEADERS.get(k, k).ljust(12)
                        for k in self.thermo_style)
        self._log(line.rstrip())

    def _thermo_value(self, vals, key):
        """A thermo_style custom column (tpumd/md/simulation.py:1605-1646):
        a keyword, c_ID or c_ID[i] (packed into the row, or one of the
        reference's thermo computes), v_name (an equal-style variable,
        evaluated on this row) or f_ID or f_ID[i] (a fix's output)."""
        if key in vals:
            return vals[key]
        name, idx = key[2:], None
        if "[" in name:
            name, rest = name.split("[", 1)
            idx = int(rest.rstrip("]")) - 1
        if key.startswith("c_") and idx is None and name in THERMO_COMPUTES:
            return vals[THERMO_COMPUTES[name]]
        if key.startswith("v_") and idx is None:
            return float(self.script.evaluate_variable(name))
        if key.startswith("f_"):
            for fx in self.fixes:
                if fx.id == name and hasattr(fx, "output"):
                    out = fx.output(self)
                    return float(out if idx is None else
                                 np.asarray(out)[idx])
            raise ValueError(f"thermo_style {key}: no fix {name} with "
                             "an output")
        raise ValueError(f"thermo_style {key} is not a thermo value")

    def _thermo_line(self):
        vals = self.thermo_values()
        if self.thermo_multi:
            self.thermo_rows.append(dict(vals))
            return self._thermo_lines_multi(vals)
        parts = []
        for k in self.thermo_style:
            v = self._thermo_value(vals, k)
            vals[k] = v     # custom columns land in last_thermo too
            parts.append(f"{v:8d}" if k == "step" else f"{v:12.8g}")
        self.thermo_rows.append(dict(vals))
        self._log(" ".join(parts))

    def _log(self, line: str):
        self.log_lines.append(line)
        if self.log_fh is not None:
            self.log_fh.write(line + "\n")
            self.log_fh.flush()
        if self.verbose:
            print(line, flush=True)

    # ------------------------------------------------------------------ perf
    def performance(self) -> dict:
        """Matom-step/s report (formula of src/finish.cpp:141-160)."""
        if self.loop_time == 0:
            return {}
        steps_per_s = self.loop_steps / self.loop_time
        return {
            "loop_time": self.loop_time,
            "timesteps_per_s": steps_per_s,
            "matom_steps_per_s": steps_per_s * self.natoms / 1e6,
        }
