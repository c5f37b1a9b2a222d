"""LAMMPS-dialect input-script front end for the port.

The command subset of tpumd/script/parser.py (the reference's Input
interpreter, src/input.cpp) that the LJ-melt, chain, eam, rhodo_class and
chute decks use: line continuation (&), comment stripping and an
order-sensitive command state machine driving a ``Simulation``.  Styles named before
read_data are made once it has set the type counts.  Any other command
raises NotImplementedError naming itself.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpumd_torch.core.atomvec import get_style
from tpumd_torch.core.create import create_atoms_lattice, remap_host, \
    remap_triclinic_host
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.region import BlockRegion
from tpumd_torch.core.state import Box, make_state, map_per_atom
from tpumd_torch.core.velocity_cmd import velocity_create_geom
from tpumd_torch.io.read_data import build_special, read_data
from tpumd_torch.md.fix_langevin import FixLangevin
from tpumd_torch.md.fix_nh import FixNH
from tpumd_torch.md.computes import ComputeERotateSphere
from tpumd_torch.md.fix_shake import FixShake
from tpumd_torch.md.fix_sphere import FixFreeze, FixGravity, FixNVESphere
from tpumd_torch.md.fixes import FixNVE
from tpumd_torch.md.simulation import THERMO_KEYS, Simulation, \
    resolve_device
from tpumd_torch.models.kspace_pppm import PPPM
from tpumd_torch.models.registry import create_bonded_style, \
    create_pair_style

BONDED_KINDS = ("bond", "angle", "dihedral", "improper")


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
        # styles named before read_data sets the type counts
        self._pending_bonded: dict = {}
        self._pending_pair = None
        self._pending_pair_modify: dict = {}
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
        boundary = None if self.sim is None else self.sim.boundary
        self.sim = Simulation(units=a[0], device=self.device,
                              dtype=self.dtype)
        if boundary is not None:
            self.sim.boundary = boundary   # a boundary command may come first

    def cmd_atom_style(self, a):
        get_style(a[0])   # raises for a style the port does not have
        self.atom_style = a[0]

    def cmd_boundary(self, a):
        """Per axis p, or a face pair of f (fixed), s (shrink-wrapped) and
        m (shrink-wrapped with a minimum) (tpumd/script/parser.py:491)."""
        if len(a) != 3 or any(len(t) > 2 or set(t) - set("pfsm")
                              or ("p" in t and t != "p") for t in a):
            raise ScriptError(f"boundary {' '.join(a)} is not a boundary")
        if self.box is not None or (self.sim is not None
                                    and self.sim.state is not None):
            raise ScriptError("boundary command after the simulation box "
                              "is defined")
        self._require_sim().boundary = tuple(a)

    def cmd_newton(self, a):
        pass   # every sweep sums both sides of a pair on its own atom

    def cmd_comm_modify(self, a):
        pass   # no ghost atoms: partners' velocities are read in place

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
        periodic = tuple(t == "p" for t in sim.boundary)
        x = np.ascontiguousarray(d.x, dtype=np.float64)
        if d.tilt is not None and np.any(d.tilt != 0):
            # a triclinic box remaps through lamda space, as the reference
            # does; the round trip moves coordinates by an ulp, which the
            # loop-geom velocity hash sees
            x, shift = remap_triclinic_host(x, d.box_lo, d.box_hi, d.tilt,
                                            periodic)
            image = d.image + shift
            box = Box.triclinic(d.box_lo, d.box_hi, d.tilt,
                                device=sim.device, dtype=self.dtype,
                                periodic=periodic)
        else:
            image = d.image + remap_host(x, d.box_lo, d.box_hi, periodic)
            box = Box.orthogonal(d.box_lo, d.box_hi, device=sim.device,
                                 dtype=self.dtype, periodic=periodic)
        sim.state = make_state(x, d.v, d.types, box, image=image,
                               molecule=d.molecule, q=d.q, radius=d.radius,
                               rmass=d.rmass, omega=d.omega,
                               device=sim.device, dtype=self.dtype)
        sim.topology = {}
        for kind in BONDED_KINDS:
            arr = getattr(d, kind + "s")
            sim.bonded_ntypes[kind] = getattr(d, f"n{kind}types")
            if arr is not None and len(arr):
                sim.topology[kind] = arr
        sim.special_tags = sim.special_codes = None
        if d.bonds is not None and len(d.bonds):
            sim.special_tags, sim.special_codes = build_special(
                d.natoms, d.bonds)
        self._materialize_styles()
        # coefficient sections of the data file
        if "Pair Coeffs" in d.coeffs:
            if not hasattr(sim.pair, "coeff_from_data"):
                raise NotImplementedError(
                    f"Pair Coeffs in the data file for pair_style "
                    f"{getattr(sim.pair, 'name', None)}")
            sim.pair.coeff_from_data(d.coeffs["Pair Coeffs"])
        for kind in BONDED_KINDS:
            rows = d.coeffs.get(kind.capitalize() + " Coeffs")
            if rows is not None and kind in sim.bonded:
                for r in rows:
                    sim.bonded[kind].coeff(int(r[0]),
                                           *[float(v) for v in r[1:]])

    def _materialize_styles(self):
        """Make the styles named before read_data (src/input.cpp defers
        nothing; the port needs the type counts first)."""
        sim = self.sim
        if self._pending_pair is not None:
            name, args = self._pending_pair
            sim.pair = create_pair_style(name, sim.ntypes, args,
                                         units=sim.units)
            self._pending_pair = None
            self._apply_pair_modify(self._pending_pair_modify)
            self._pending_pair_modify = {}
        for kind, name in self._pending_bonded.items():
            self._add_bonded(kind, name)
        self._pending_bonded = {}

    def _add_bonded(self, kind, name):
        sim = self.sim
        style = create_bonded_style(kind, name, (),
                                    sim.bonded_ntypes.get(kind, 0))
        if not style.kernel_bond and self.atom_style != "full":
            raise NotImplementedError(
                f"{kind}_style {name} with atom_style {self.atom_style}: "
                "the port evaluates per-tuple bonded styles only for "
                "atom_style full, beside lj/charmm/coul/long, whose kernel "
                "excludes the special pairs")
        sim.bonded[kind] = style

    def _bonded_style(self, kind, a):
        sim = self._require_sim()
        if a[0] == "none":
            sim.bonded.pop(kind, None)
            self._pending_bonded.pop(kind, None)
            return
        create_bonded_style(kind, a[0], a[1:], 0)  # raises if not ported
        if kind not in sim.bonded_ntypes:
            self._pending_bonded[kind] = a[0]    # before read_data: defer
        else:
            self._add_bonded(kind, a[0])

    def _bonded_coeff(self, kind, a):
        if self.sim is None or kind not in self.sim.bonded:
            raise ScriptError(f"{kind}_coeff before {kind}_style")
        self.sim.bonded[kind].coeff(int(a[0]), *[float(v) for v in a[1:]])

    def cmd_bond_style(self, a):
        self._bonded_style("bond", a)

    def cmd_angle_style(self, a):
        self._bonded_style("angle", a)

    def cmd_dihedral_style(self, a):
        self._bonded_style("dihedral", a)

    def cmd_improper_style(self, a):
        self._bonded_style("improper", a)

    def cmd_bond_coeff(self, a):
        self._bonded_coeff("bond", a)

    def cmd_angle_coeff(self, a):
        self._bonded_coeff("angle", a)

    def cmd_dihedral_coeff(self, a):
        self._bonded_coeff("dihedral", a)

    def cmd_improper_coeff(self, a):
        self._bonded_coeff("improper", a)

    # special_bonds presets: the 1-2, 1-3, 1-4 (lj, coul) weights
    # (src/special.cpp, tpumd/script/parser.py:2683)
    _SPECIAL_BONDS = {"fene": ((0.0, 1.0, 1.0), (0.0, 1.0, 1.0)),
                      "charmm": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                      "amber": ((0.0, 0.0, 0.5), (0.0, 0.0, 1.0 / 1.2))}

    def cmd_special_bonds(self, a):
        if a[0] == "lj/coul" and len(a) == 4:
            w = tuple(float(v) for v in a[1:4])
            wl = wc = w
        elif a[0] in self._SPECIAL_BONDS and len(a) == 1:
            wl, wc = self._SPECIAL_BONDS[a[0]]
        else:
            raise NotImplementedError(
                f"special_bonds {' '.join(a)} is not ported")
        sim = self._require_sim()
        sim.special_lj = np.array((1.0,) + wl)
        sim.special_coul = np.array((1.0,) + wc)
        sim.invalidate_ctx()

    def cmd_kspace_style(self, a):
        if a[0] != "pppm" or len(a) != 2:
            raise NotImplementedError(
                f"kspace_style {' '.join(a)} is not ported (only pppm "
                "accuracy)")
        sim = self._require_sim()
        sim.kspace = PPPM(float(a[1]))
        sim.invalidate_ctx()

    def cmd_replicate(self, a):
        """Tile the system nx x ny x nz (src/replicate.cpp, tpumd/script/
        parser.py:2622-2681): atoms unwrapped by their image flags and
        shifted by box images, then tags, molecules, topology and special
        tags offset per replica."""
        if len(a) != 3:
            raise NotImplementedError(f"replicate keywords {a[3:]} are not "
                                      "ported")
        nx, ny, nz = (int(v) for v in a)
        if (nx, ny, nz) == (1, 1, 1):
            return
        sim = self.sim
        if sim.state.box.istriclinic:
            raise NotImplementedError("replicate of a triclinic box is not "
                                      "ported")
        sim.invalidate_ctx()   # back to natoms rows after an earlier run
        # rows in tag order: replica r's atom k takes tag k + r n
        order = torch.argsort(sim.state.tag)
        s = map_per_atom(sim.state, lambda t: t[order])
        n = sim.natoms
        lo = s.box.lo.cpu().numpy().astype(np.float64)
        ell = s.box.lengths_np()
        x = s.x.cpu().numpy().astype(np.float64) \
            + s.image.cpu().numpy() * ell
        v = s.v.cpu().numpy().astype(np.float64)
        reps = [(i, j, k) for k in range(nz) for j in range(ny)
                for i in range(nx)]
        nrep = len(reps)
        xs = np.concatenate([x + np.array(r) * ell for r in reps])
        mol = None if s.molecule is None else s.molecule.cpu().numpy()
        maxmol = int(mol.max()) if mol is not None and len(mol) else 0
        box = Box.orthogonal(lo, lo + ell * np.array([nx, ny, nz]),
                             device=sim.device, dtype=self.dtype,
                             periodic=s.box.periodic)
        sim.state = make_state(
            xs, np.tile(v, (nrep, 1)), np.tile(s.type.cpu().numpy(), nrep),
            box, molecule=None if mol is None else np.concatenate(
                [mol + r * maxmol for r in range(nrep)]),
            q=None if s.q is None else np.tile(
                s.q.cpu().numpy().astype(np.float64), nrep),
            device=sim.device, dtype=self.dtype)
        sim._natoms = None
        for kind, arr in sim.topology.items():
            out = []
            for r in range(nrep):
                rep = arr.copy()
                rep[:, 1:] += r * n
                out.append(rep)
            sim.topology[kind] = np.concatenate(out)
        if sim.special_tags is not None:
            st = sim.special_tags
            sim.special_tags = np.concatenate(
                [np.where(st > 0, st + r * n, 0) for r in range(nrep)])
            sim.special_codes = np.tile(sim.special_codes, (nrep, 1))
        sim.invalidate_ctx()

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
        self._materialize_styles()

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
            box = Box.orthogonal(lo, hi, device=sim.device, dtype=self.dtype,
                                 periodic=tuple(t == "p"
                                                for t in sim.boundary))
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
        sim.build_shake()   # SHAKE's removed dof enter the scaling
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
            # before create_box or read_data: made once the types are known
            create_pair_style(a[0], 1, a[1:])   # raises if not ported
            self._pending_pair = (a[0], a[1:])
            sim.pair = None
        else:
            sim.pair = create_pair_style(a[0], sim.ntypes, a[1:],
                                         units=sim.units)

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
        if self.sim.pair is None:
            self._pending_pair_modify.update(kw)
            return
        self._apply_pair_modify(kw)

    def _apply_pair_modify(self, kw):
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
        if a and a[0] == "exclude":
            return self._neigh_exclude(a)
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

    def _neigh_exclude(self, a):
        """neigh_modify exclude group g1 g2 (src/neighbor.cpp exclusion
        lists, tpumd/script/parser.py:1102-1110): pairs of a g1 and a g2
        atom are never in contact."""
        sim = self.sim
        if len(a) != 4 or a[1] != "group":
            raise NotImplementedError(
                f"neigh_modify {' '.join(a)} is not ported (only exclude "
                "group g1 g2)")
        sim.neigh_exclude += ((self._group_bit(a[2]), self._group_bit(a[3])),)
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
            unknown = [k for k in a[1:] if k not in THERMO_KEYS
                       and not (k.startswith("c_") and "[" not in k)]
            if unknown:
                raise NotImplementedError(
                    f"thermo_style custom keywords {unknown} are not ported")
            sim.thermo_style = a[1:]
        else:
            raise NotImplementedError(f"thermo_style {a[0]} is not ported")

    def cmd_thermo_modify(self, a):
        kw = dict(zip(a[::2], a[1::2]))
        if len(a) % 2 or set(kw) - {"norm"} or kw["norm"] not in ("yes",
                                                               "no"):
            raise NotImplementedError(
                f"thermo_modify {' '.join(a)} is not ported (only norm "
                "yes|no)")
        self._require_sim().thermo_norm = kw["norm"] == "yes"

    def _group_bit(self, name):
        if name not in self.sim.groups:
            raise ScriptError(f"undefined group {name!r}")
        return self.sim.groups[name]

    def cmd_group(self, a):
        """group name type t... | subtract g1 g2... (src/group.cpp,
        tpumd/script/parser.py:1689): each group is one bit of the atoms'
        gmask, bit 1 being group all."""
        if self.sim is None or (self.sim.state is None
                                and not self._atoms_x):
            raise ScriptError("group before the atoms exist")
        self._finalize_atoms()
        sim = self.sim
        name, style = a[0], a[1]
        if style not in ("type", "subtract") or len(a) < 3:
            raise NotImplementedError(
                f"group {' '.join(a[1:])} is not ported (only type and "
                "subtract)")
        sim.invalidate_ctx()
        s = sim.state
        gm = (torch.ones_like(s.tag) if s.gmask is None
              else s.gmask.clone())
        if style == "type":
            sel = torch.zeros_like(s.tag, dtype=torch.bool)
            for tok in a[2:]:
                if ":" in tok:
                    lo, hi = (int(v) for v in tok.split(":"))
                    sel |= (s.type >= lo) & (s.type <= hi)
                else:
                    sel |= s.type == int(tok)
        else:
            sel = (gm & self._group_bit(a[2])) > 0
            for other in a[3:]:
                sel &= (gm & self._group_bit(other)) == 0
        bit = sim.groups.setdefault(name, 1 << len(sim.groups))
        sim.state = s.replace(gmask=torch.where(sel, gm | bit, gm))

    def cmd_compute(self, a):
        cid, group, style = a[0], a[1], a[2]
        if style != "erotate/sphere" or len(a) != 3:
            raise NotImplementedError(
                f"compute {' '.join(a[2:])} is not ported (only "
                "erotate/sphere)")
        self._require_sim().computes[cid] = ComputeERotateSphere(
            cid, self._group_bit(group))

    # the fixes that take a group other than all
    _GROUP_FIXES = ("nve/sphere", "freeze", "gravity")

    def cmd_fix(self, a):
        sim = self.sim
        fid, group, style, args = a[0], a[1], a[2], a[3:]
        if group != "all" and style not in self._GROUP_FIXES:
            raise NotImplementedError(
                f"fix {fid} {style} on group {group!r}: only "
                f"{', '.join(self._GROUP_FIXES)} act on a group")
        if style == "nve/sphere" and not args:
            fx = FixNVESphere()
        elif style == "freeze" and not args:
            fx = FixFreeze()
        elif style == "gravity" and len(args) >= 2:
            fx = FixGravity(args[0], args[1], *args[2:])
        elif style == "nve" and not args:
            fx = FixNVE()
        elif style == "langevin" and len(args) == 4:
            fx = FixLangevin(*args[:3], int(args[3]), device=sim.device)
        elif style in ("nvt", "npt"):
            fx = FixNH.parse(style, args)
        elif style == "shake":
            fx = FixShake.parse(args)
        else:
            raise NotImplementedError(
                f"fix {' '.join(a[1:])!r} is not ported (only 'all nve', "
                "'all langevin Tstart Tstop damp seed', nvt, npt, shake, "
                "nve/sphere, freeze and gravity)")
        sim.fixes = [fx for fx in sim.fixes if fx.id != fid]
        fx.id = fid
        fx.groupbit = self._group_bit(group)
        sim.fixes.append(fx)
        sim.invalidate_ctx()

    def cmd_run(self, a):
        if len(a) != 1:
            raise NotImplementedError(f"run keywords {a[1:]} are not ported")
        self._finalize_atoms()
        self.sim.run(int(a[0]))
