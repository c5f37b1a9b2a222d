"""LAMMPS-dialect input-script front end for the port.

The command subset of tpumd/script/parser.py (the reference's Input
interpreter, src/input.cpp) that the LJ-melt, chain and eam decks use: line
continuation (&), comment stripping and an order-sensitive command state
machine driving a ``Simulation``.  Any other command raises
NotImplementedError naming itself.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpumd_torch.core.atomvec import get_style
from tpumd_torch.core.create import create_atoms_lattice, remap_host
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.region import BlockRegion
from tpumd_torch.core.state import Box, make_state
from tpumd_torch.core.velocity_cmd import velocity_create_geom
from tpumd_torch.io.read_data import build_special, read_data
from tpumd_torch.md.fix_langevin import FixLangevin
from tpumd_torch.md.fixes import FixNVE
from tpumd_torch.md.simulation import THERMO_KEYS, Simulation, \
    resolve_device
from tpumd_torch.models.registry import create_bonded_style, \
    create_pair_style


class ScriptError(RuntimeError):
    pass


class LammpsScript:
    """Parses and executes a LAMMPS input script against a Simulation on
    the given device, in the given float dtype.  Asking for CUDA on a
    machine without a card raises here.  Relative data-file and potential
    paths resolve against the deck's directory under ``run_file``, else the
    working directory."""

    def __init__(self, *, device="cuda", dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.data_dir = "."
        self.atom_style = "atomic"
        self._pending_bond = None
        self.sim: Simulation | None = None
        self.lattice: Lattice | None = None
        self.regions: dict[str, BlockRegion] = {}
        self.box = None
        self._atoms_x: list[np.ndarray] = []
        self._atoms_type: list[np.ndarray] = []
        self._units_name = "lj"

    # -------------------------------------------------------------- plumbing
    def run_file(self, path: str):
        self.data_dir = os.path.dirname(os.path.abspath(path))
        with open(path) as fh:
            self.run_string(fh.read())

    @staticmethod
    def _to_logical(text: str):
        logical = []
        cont = ""
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip() and not cont:
                continue
            if line.endswith("&"):
                cont += line[:-1] + " "
                continue
            logical.append(cont + line)
            cont = ""
        return logical

    def run_string(self, text: str):
        for line in self._to_logical(text):
            self.execute(line)

    def execute(self, line: str):
        args = line.split()
        if not args:
            return
        cmd, args = args[0], args[1:]
        handler = getattr(self, "cmd_" + cmd.replace("/", "_"), None)
        if handler is None:
            raise NotImplementedError(
                f"command {cmd!r} is not ported to tpumd_torch")
        handler(args)

    def _require_sim(self) -> Simulation:
        if self.sim is None:
            self.sim = Simulation(units=self._units_name, device=self.device,
                                  dtype=self.dtype)
        return self.sim

    # -------------------------------------------------------------- commands
    def cmd_units(self, a):
        self._units_name = a[0]
        self.sim = Simulation(units=a[0], device=self.device,
                              dtype=self.dtype)

    def cmd_atom_style(self, a):
        get_style(a[0])   # raises for a style the port does not have
        self.atom_style = a[0]

    def cmd_read_data(self, a):
        if len(a) != 1:
            raise NotImplementedError(
                f"read_data keywords {a[1:]} are not ported")
        path = a[0]
        if not os.path.isabs(path):
            path = os.path.join(self.data_dir, path)
        sim = self._require_sim()
        d = read_data(path, self.atom_style)
        sim.ntypes = d.natomtypes
        sim.mass = d.masses.copy()
        # the reference remaps every read atom into the box
        # (src/atom.cpp:1176 -> Domain::remap) and folds the shift into
        # the image flags
        x = np.ascontiguousarray(d.x, dtype=np.float64)
        image = d.image + remap_host(x, d.box_lo, d.box_hi,
                                     (True, True, True))
        box = Box.orthogonal(d.box_lo, d.box_hi, device=sim.device,
                             dtype=self.dtype)
        sim.state = make_state(x, d.v, d.types, box, image=image,
                               molecule=d.molecule, device=sim.device,
                               dtype=self.dtype)
        sim.nbondtypes = d.nbondtypes
        sim.bonds = d.bonds
        sim.special_tags = sim.special_codes = None
        if d.bonds is not None and len(d.bonds):
            sim.special_tags, sim.special_codes = build_special(
                d.natoms, d.bonds)
        if self._pending_bond is not None:
            sim.bond = create_bonded_style("bond", *self._pending_bond,
                                           sim.nbondtypes)
            self._pending_bond = None

    def cmd_bond_style(self, a):
        sim = self._require_sim()
        if a[0] == "none":
            sim.bond = None
        elif sim.nbondtypes is None:
            self._pending_bond = (a[0], a[1:])   # before read_data: defer
        else:
            sim.bond = create_bonded_style("bond", a[0], a[1:],
                                           sim.nbondtypes)

    def cmd_bond_coeff(self, a):
        if self.sim is None or self.sim.bond is None:
            raise ScriptError("bond_coeff before bond_style")
        self.sim.bond.coeff(int(a[0]), *[float(v) for v in a[1:]])

    # special_bonds presets: the 1-2, 1-3, 1-4 lj weights (the port has
    # no charges, so the coul weights are not kept)
    _SPECIAL_BONDS = {"fene": (0.0, 1.0, 1.0), "charmm": (0.0, 0.0, 0.0),
                      "amber": (0.0, 0.0, 0.5)}

    def cmd_special_bonds(self, a):
        if a[0] == "lj/coul":
            w = tuple(float(v) for v in a[1:4])
        elif a[0] in self._SPECIAL_BONDS:
            w = self._SPECIAL_BONDS[a[0]]
        else:
            raise NotImplementedError(f"special_bonds {a[0]} is not ported")
        self._require_sim().special_lj = np.array((1.0,) + w)

    def cmd_lattice(self, a):
        sim = self._require_sim()
        self.lattice = Lattice(a[0], float(a[1]), units=sim.units.name,
                               dimension=sim.dimension, args=a[2:])

    def cmd_region(self, a):
        name, style = a[0], a[1]
        if style != "block":
            raise NotImplementedError(f"region style {style!r} is not ported")
        vals = [float(v) for v in a[2:8]]
        rest = a[8:]
        if rest and rest != ["units", "box"] and rest != ["units", "lattice"]:
            raise ScriptError(f"region keywords {rest} not supported")
        # lattice units by default, when a lattice exists
        if self.lattice is not None and rest != ["units", "box"]:
            sp = self.lattice.spacing
            lo = [vals[0] * sp[0], vals[2] * sp[1], vals[4] * sp[2]]
            hi = [vals[1] * sp[0], vals[3] * sp[1], vals[5] * sp[2]]
        else:
            lo = [vals[0], vals[2], vals[4]]
            hi = [vals[1], vals[3], vals[5]]
        self.regions[name] = BlockRegion(lo, hi)

    def cmd_create_box(self, a):
        if len(a) != 2:
            raise ScriptError(f"create_box keywords {a[2:]} not supported")
        ntypes = int(a[0])
        self.box = self.regions[a[1]].bounding_box()
        sim = self._require_sim()
        sim.ntypes = ntypes
        sim.mass = np.zeros(ntypes + 1)

    def cmd_create_atoms(self, a):
        type_id, style = int(a[0]), a[1]
        lo, hi = self.box
        if style == "box" and len(a) == 2:
            x, t = create_atoms_lattice(self.lattice, None, lo, hi, type_id)
        elif style == "region" and len(a) == 3:
            x, t = create_atoms_lattice(self.lattice, self.regions[a[2]],
                                        lo, hi, type_id, fill_box=False)
        else:
            raise NotImplementedError(
                f"create_atoms {' '.join(a[1:])!r} is not ported")
        self._atoms_x.append(x)
        self._atoms_type.append(t)

    def cmd_mass(self, a):
        sim = self._require_sim()
        if a[0] == "*":
            sim.mass[1:] = float(a[1])
        else:
            sim.mass[int(a[0])] = float(a[1])

    def _finalize_atoms(self):
        sim = self.sim
        if sim.state is None:
            x = np.concatenate(self._atoms_x)
            t = np.concatenate(self._atoms_type)
            lo, hi = self.box
            box = Box.orthogonal(lo, hi, device=sim.device, dtype=self.dtype)
            sim.state = make_state(x, np.zeros_like(x), t, box,
                                   device=sim.device, dtype=self.dtype)

    def cmd_velocity(self, a):
        self._finalize_atoms()
        sim = self.sim
        group, style = a[0], a[1]
        if group != "all" or style != "create":
            raise NotImplementedError(
                f"velocity {group} {style} is not ported (only 'all create')")
        t_desired, seed = float(a[2]), int(a[3])
        kw = dict(zip(a[4::2], a[5::2]))
        if kw.get("loop", "all") != "geom":
            raise NotImplementedError(
                "only 'loop geom' velocity creation is ported")
        # the hash reads the positions as stored, in the run's dtype
        x = sim.state.x.cpu().numpy().astype(np.float64)
        masses = sim.mass[sim.state.type.cpu().numpy()]
        fix_dof = sum(fx.dof_removed for fx in sim.fixes)
        v = velocity_create_geom(
            x, masses, t_desired, seed,
            boltz=sim.units.boltz, mvv2e=sim.units.mvv2e,
            dist=kw.get("dist", "uniform"),
            zero_momentum=kw.get("mom", "yes") == "yes",
            dimension=sim.dimension,
            extra_dof=sim.dimension + fix_dof,
        )
        sim.state = sim.state.replace(
            v=torch.as_tensor(v, dtype=self.dtype, device=sim.device))

    def cmd_pair_style(self, a):
        sim = self._require_sim()
        if sim.ntypes == 0:
            raise ScriptError("pair_style before create_box")
        sim.pair = create_pair_style(a[0], sim.ntypes, a[1:])

    def cmd_pair_coeff(self, a):
        sim = self.sim

        def parse_range(tok, n):
            if tok == "*":
                return 1, n
            if tok.endswith("*"):
                return int(tok[:-1]), n
            if tok.startswith("*"):
                return 1, int(tok[1:])
            return int(tok), int(tok)

        ilo, ihi = parse_range(a[0], sim.ntypes)
        jlo, jhi = parse_range(a[1], sim.ntypes)
        # numbers, else a potential file (relative paths resolve against
        # the deck's directory where the file is found there) or an
        # element name
        rest = []
        for tok in a[2:]:
            try:
                rest.append(float(tok))
            except ValueError:
                path = os.path.join(self.data_dir, tok)
                rest.append(path if not os.path.isabs(tok)
                            and os.path.exists(path) else tok)
        sim.pair.coeff(ilo, ihi, jlo, jhi, *rest)
        # potentials that carry per-type masses (EAM files) set them, as
        # the reference does: in.eam has no mass command
        pmass = getattr(sim.pair, "mass", None)
        if pmass is not None:
            nz = np.nonzero(pmass)[0]
            sim.mass[nz] = pmass[nz]

    def cmd_pair_modify(self, a):
        kw = dict(zip(a[::2], a[1::2]))
        pair = self.sim.pair
        for key, val in kw.items():
            if key == "shift":
                pair.shift = val == "yes"
            elif key == "mix":
                pair.mix = val
            elif key == "tail":
                pair.tail_flag = val == "yes"
            else:
                raise NotImplementedError(f"pair_modify {key} is not ported")
        self.sim.invalidate_ctx()

    def cmd_neighbor(self, a):
        sim = self._require_sim()
        sim.skin = float(a[0])
        if a[1] != "bin":
            raise NotImplementedError(f"neighbor style {a[1]!r} is not ported")

    def cmd_neigh_modify(self, a):
        sim = self._require_sim()
        for key, val in zip(a[::2], a[1::2]):
            if key == "delay":
                sim.neigh_delay = int(val)
            elif key == "every":
                sim.neigh_every = int(val)
            elif key == "check":
                sim.neigh_check = val == "yes"
            else:
                raise NotImplementedError(
                    f"neigh_modify {key} is not ported")
        if len(a) % 2:
            raise ScriptError(f"neigh_modify: odd argument list {a}")
        sim.invalidate_ctx()

    def cmd_timestep(self, a):
        self._require_sim().dt = float(a[0])
        self.sim.invalidate_ctx()

    def cmd_thermo(self, a):
        self._require_sim().thermo_every = int(a[0])

    def cmd_thermo_style(self, a):
        sim = self._require_sim()
        if a[0] == "one":
            sim.thermo_style = ["step", "temp", "epair", "emol", "etotal",
                                "press"]
        elif a[0] == "custom":
            unknown = [k for k in a[1:] if k not in THERMO_KEYS]
            if unknown:
                raise NotImplementedError(
                    f"thermo_style custom keywords {unknown} are not ported")
            sim.thermo_style = a[1:]
        else:
            raise NotImplementedError(f"thermo_style {a[0]} is not ported")

    def cmd_fix(self, a):
        sim = self.sim
        fid, group, style, args = a[0], a[1], a[2], a[3:]
        if group == "all" and style == "nve" and not args:
            fx = FixNVE()
        elif group == "all" and style == "langevin" and len(args) == 4:
            fx = FixLangevin(*args[:3], int(args[3]), device=sim.device)
        else:
            raise NotImplementedError(
                f"fix {' '.join(a[1:])!r} is not ported (only 'all nve' and "
                "'all langevin Tstart Tstop damp seed')")
        sim.fixes = [fx for fx in sim.fixes if fx.id != fid]
        fx.id = fid
        sim.fixes.append(fx)
        sim.invalidate_ctx()

    def cmd_run(self, a):
        if len(a) != 1:
            raise NotImplementedError(f"run keywords {a[1:]} are not ported")
        self._finalize_atoms()
        self.sim.run(int(a[0]))
