"""Embedding API: drive the port from a program as the reference's library
interface is driven (src/library.h:123-253, python/lammps/core.py), the
counterpart of tpumd/api.py.

``TpuMD(device="cuda", dtype=torch.float32)`` holds one LammpsScript: feed
it commands, read globals, per-atom arrays, computes, fixes and variables,
gather and scatter per-atom data in tag order, and drive fix external.

Contracts:

- ``extract_atom`` returns a HOST COPY (numpy) of the live atoms' rows in
  the engine's current row order (on the cell grid, grid-slot order less
  the empty slots; it changes at every re-bin), never a pointer into device
  memory: a write into it changes nothing.  ``gather_atoms`` returns the
  same data sorted by tag.
- ``scatter_atoms``, ``reset_box`` and ``create_atoms`` are host edits:
  they go through ``LammpsScript._host_edit`` (the state back in natoms
  rows, the set-up dropped), so that the next run sets up anew and sees the
  edit; where the instance had run, it sets up again at once, so that the
  thermo queries read the edited state.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.script.parser import LammpsScript


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class TpuMD:
    """An embedded simulation instance (the analog of ``lammps.lammps``)."""

    def __init__(self, device="cuda", dtype=torch.float32, data_dir=".",
                 var_overrides=None):
        self._script = LammpsScript(device=device, dtype=dtype,
                                    var_overrides=var_overrides)
        self._script.data_dir = data_dir

    # ----------------------------------------------------------- commands
    def command(self, cmd: str):
        self._script.execute(cmd)

    def commands_string(self, text: str):
        self._script.run_string(text)

    def file(self, path: str):
        self._script.run_file(path)

    # ------------------------------------------------------------- simple
    @property
    def sim(self):
        return self._script.sim

    def _ready(self):
        """The simulation with its atoms made (lammps_* calls may come
        before the first run)."""
        self._script._finalize_atoms()
        return self.sim

    def get_natoms(self) -> int:
        return self.sim.natoms

    def get_thermo(self, name: str):
        """lammps_get_thermo: step, temp, press, pe, ke, etotal, vol, ..."""
        return self.sim.thermo_values()[name]

    def extract_box(self):
        box = self._ready().state.box
        return _host(box.lo).astype(np.float64), \
            _host(box.hi).astype(np.float64)

    def extract_global(self, name: str):
        sim = self._ready()
        lo, hi = self.extract_box()
        table = {"natoms": sim.natoms, "ntypes": sim.ntypes, "dt": sim.dt,
                 "ntimestep": sim.step, "units": sim.units.name,
                 "boxlo": lo, "boxhi": hi, "boltz": sim.units.boltz}
        return table[name]

    # ------------------------------------------------------------ per-atom
    _FIELDS = {"x": "x", "v": "v", "f": "f", "type": "type", "id": "tag",
               "tag": "tag", "image": "image", "q": "q",
               "molecule": "molecule", "mask": "gmask", "radius": "radius",
               "rmass": "rmass", "omega": "omega", "torque": "torque"}

    def extract_atom(self, name: str):
        """A host copy of the per-atom array of the live atoms, in the
        engine's current row order (see the module's docstring)."""
        s = self._ready().state
        arr = getattr(s, self._FIELDS[name])
        if arr is None:
            return None
        return _host(arr[s.tag > 0])

    def gather_atoms(self, name: str):
        """Per-atom data in tag order (lammps_gather_atoms)."""
        arr = self.extract_atom(name)
        return arr[np.argsort(self.extract_atom("id"), kind="stable")]

    def scatter_atoms(self, name: str, values):
        """Set per-atom data from tag-ordered values (a host edit)."""
        had = self.sim is not None and self.sim._carry is not None
        sim = self._script._host_edit()
        s = sim.state
        attr = self._FIELDS[name]
        cur = getattr(s, attr)
        rows = torch.as_tensor(s.tag.long() - 1, device=cur.device)
        vals = torch.as_tensor(np.asarray(values), dtype=cur.dtype,
                               device=cur.device)
        sim.state = s.replace(**{attr: vals.reshape(
            (-1,) + tuple(cur.shape[1:]))[rows]})
        if had:
            sim.setup()

    # ------------------------------------------- computes/fixes/variables
    def extract_compute(self, cid: str, style: int = 0, type: int = 0):
        """lammps_extract_compute: style 0 global, 1 per-atom (tag order);
        type 0 scalar, 1 vector, 2 array."""
        sim = self.sim
        out = sim.computes[cid](sim)
        arr = _host(torch.as_tensor(out)).astype(np.float64)
        if style == 0 and type == 0:
            return float(arr.reshape(-1)[0])
        if style == 0 and type == 1:
            return arr.reshape(-1)
        return arr

    def _fix(self, fid: str):
        for fx in self.sim.fixes:
            if getattr(fx, "id", None) == fid:
                return fx
        raise KeyError(f"unknown fix id {fid!r}")

    def extract_fix(self, fid: str, style: int = 0, type: int = 0,
                    nrow: int = 0, ncol: int = 0):
        """lammps_extract_fix: the fix's global scalar (type 0), one
        element of its global vector (type 1, 0-based nrow) or array (type
        2), as the reference's contract."""
        fx, sim = self._fix(fid), self.sim
        if type == 0:
            if hasattr(fx, "scalar"):
                return float(fx.scalar(sim))
            if hasattr(fx, "output"):
                return float(np.asarray(fx.output(sim)).reshape(-1)[0])
            raise KeyError(f"fix {fid} has no global scalar")
        vec = getattr(fx, "vector", None)
        if vec is None and hasattr(fx, "output"):
            vec = fx.output(sim)
        if vec is None:
            raise KeyError(f"fix {fid} has no global vector")
        vec = np.asarray(vec, dtype=np.float64)
        if type == 1:
            return float(vec.reshape(-1)[nrow])
        if type == 2:
            return float(np.atleast_2d(vec)[nrow, ncol])
        return vec

    def extract_variable(self, name: str, group: str | None = None):
        """lammps_extract_variable: equal style a float, atom style a
        per-atom array in tag order, string and index styles a str."""
        out = self._script.evaluate_variable(name)
        if isinstance(out, str):
            return out
        arr = np.asarray(_host(out) if torch.is_tensor(out) else out,
                         dtype=np.float64)
        return float(arr) if arr.ndim == 0 else arr

    def set_variable(self, name: str, value) -> int:
        """lammps_set_variable: reset a string or index variable; -1 for
        any other style."""
        vars_ = self._script.variables
        style = vars_.get(name, ("string", ""))[0]
        if style not in ("string", "index"):
            return -1
        vars_[name] = (style, str(value))
        return 0

    # ------------------------------------------------------------ box/etc
    def extract_box_full(self):
        """(boxlo, boxhi, xy, yz, xz, periodicity, box_change)."""
        sim = self._ready()
        box = sim.state.box
        lo, hi = self.extract_box()
        tilt = (np.zeros(3) if box.tilt is None
                else _host(box.tilt).astype(np.float64))
        change = int(any(getattr(fx, "pstat", False) or fx.box_change
                         or fx.eos_box_change for fx in sim.fixes))
        return lo, hi, float(tilt[0]), float(tilt[2]), float(tilt[1]), \
            [int(p) for p in box.periodic], change

    def reset_box(self, boxlo, boxhi, xy=0.0, yz=0.0, xz=0.0):
        """lammps_reset_box: move the box; the atoms keep their
        coordinates (a host edit)."""
        had = self.sim is not None and self.sim._carry is not None
        sim = self._script._host_edit()
        box = sim.state.box
        kw = dict(lo=torch.as_tensor(boxlo, dtype=box.lo.dtype,
                                     device=box.lo.device),
                  hi=torch.as_tensor(boxhi, dtype=box.hi.dtype,
                                     device=box.hi.device))
        if box.tilt is not None:
            kw["tilt"] = torch.as_tensor([xy, xz, yz], dtype=box.lo.dtype,
                                         device=box.lo.device)
        elif xy or yz or xz:
            raise NotImplementedError("lammps_reset_box with a tilt on an "
                                      "orthogonal box is not ported")
        sim.state = sim.state.replace(box=box.replace(**kw))
        sim._shrink_small = None
        if had:
            sim.setup()

    def extract_setting(self, name: str) -> int:
        """lammps_extract_setting (src/library.cpp): sizes and flags; -1
        for an unknown name."""
        sim = self.sim
        s = None if sim is None else sim.state
        n = sim.natoms if sim is not None else 0
        vals = {
            "bigint": 8, "tagint": 4, "imageint": 4,
            "dimension": sim.dimension if sim is not None else 3,
            "box_exist": int(s is not None or self._script.box is not None),
            "nlocal": n, "nghost": 0, "nall": n, "natoms": n,
            "ntypes": sim.ntypes if sim is not None else 0,
            "molecule_flag": int(s is not None and s.molecule is not None),
            "q_flag": int(s is not None and s.q is not None),
            "rmass_flag": int(s is not None and s.rmass is not None),
            "triclinic": int(s is not None and s.box.istriclinic),
            "world_size": 1, "world_rank": 0,
            "universe_size": self._script.nworlds,
            "universe_rank": self._script._world_index,
            "nthreads": 1, "newton_pair": 0, "newton_bond": 0,
        }
        return int(vals.get(name, -1))

    def create_atoms(self, n, ids, types, x, v=None, image=None,
                     shrinkexceed=False):
        """lammps_create_atoms: atoms handed over as arrays after
        create_box and before the atoms are made; returns their count."""
        self._script.inject_atoms(
            None if ids is None else np.asarray(ids).reshape(n),
            np.asarray(types).reshape(n), np.asarray(x).reshape(n, 3),
            None if v is None else np.asarray(v).reshape(n, 3))
        return n

    # -------------------------------------------------------- fix external
    def _find_external(self, fid: str):
        from tpumd_torch.md.fix_external import FixExternal
        fx = self._fix(fid)
        if not isinstance(fx, FixExternal):
            raise KeyError(f"no fix external with id {fid!r}")
        return fx

    def set_fix_external_callback(self, fid: str, fn, caller=None):
        """fn(caller, timestep, nlocal, ids, x, fexternal), the reference's
        FixExternalFnPtr (src/library.h:280); x, ids and fexternal in tag
        order (md/fix_external.py)."""
        def wrapper(step, x, ids, fext):
            fn(caller, step, x.shape[0], ids, x, fext)
        self._find_external(fid).callback = wrapper

    def fix_external_get_force(self, fid: str):
        """The pf/array buffer, (N, 3) by tag - 1, pushed at the next run."""
        return self._find_external(fid).host_force_buffer(self.sim)

    def fix_external_set_energy_global(self, fid: str, eng: float):
        self._find_external(fid).energy_global = float(eng)

    def fix_external_set_virial_global(self, fid: str, virial):
        self._find_external(fid).virial_global = np.asarray(
            virial, dtype=np.float64).reshape(6)

    def fix_external_set_energy_peratom(self, fid: str, eatom):
        self._find_external(fid).energy_peratom = np.asarray(
            eatom, dtype=np.float64).reshape(-1)

    def fix_external_set_virial_peratom(self, fid: str, vatom):
        self._find_external(fid).virial_peratom = np.asarray(
            vatom, dtype=np.float64).reshape(-1, 6)

    def fix_external_set_vector_length(self, fid: str, n: int):
        self._find_external(fid).set_vector_length(n)

    def fix_external_set_vector(self, fid: str, idx: int, val: float):
        self._find_external(fid).set_vector(idx, val)

    # ------------------------------------------------- neighbor-list API
    def neighlist_half(self):
        """A half neighbour list of the current configuration at cutneigh
        (the largest cutoff plus the skin), in tag order, 0-based: a list
        of (i, sorted int32 array of j > i).  Built on the host by numpy
        cell binning, whichever engine ran the forces (tpumd/api.py:
        283-368; the reference hands out the pair style's own list)."""
        sim = self._ready()
        s = sim.state
        x = self.gather_atoms("x").astype(np.float64)
        lo, hi = self.extract_box()
        ell = hi - lo
        periodic = s.box.periodic
        cut = float(sim.max_cutoff() + sim.skin)
        n = x.shape[0]
        nc = np.maximum(1, (ell / cut).astype(int))
        rel = x - lo
        for d in range(3):
            if periodic[d]:
                rel[:, d] %= ell[d]
        cidx = np.minimum((rel / (ell / nc)).astype(int), nc - 1)
        flat = (cidx[:, 0] * nc[1] + cidx[:, 1]) * nc[2] + cidx[:, 2]
        cells: dict = {}
        for a in np.argsort(flat, kind="stable"):
            cells.setdefault(int(flat[a]), []).append(int(a))
        neighbors: list = [set() for _ in range(n)]
        offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1)]
        for key, members in cells.items():
            cx, rem = divmod(key, nc[1] * nc[2])
            cy, cz = divmod(rem, nc[2])
            mi = np.asarray(members)
            for off in offs:
                oc, shift, skip = [cx + off[0], cy + off[1], cz + off[2]], \
                    np.zeros(3), False
                for d in range(3):
                    if 0 <= oc[d] < nc[d]:
                        continue
                    if not periodic[d]:
                        skip = True
                        break
                    shift[d] = -np.floor(oc[d] / nc[d]) * ell[d]
                    oc[d] %= nc[d]
                if skip:
                    continue
                other = cells.get(int((oc[0] * nc[1] + oc[1]) * nc[2]
                                      + oc[2]))
                if other is None:
                    continue
                mj = np.asarray(other)
                d2 = rel[mi][:, None, :] - (rel[mj][None, :, :] - shift)
                for d in range(3):
                    if periodic[d] and nc[d] < 3:
                        d2[..., d] -= np.round(d2[..., d] / ell[d]) * ell[d]
                hit = np.sum(d2 * d2, axis=-1) < cut * cut
                for a, row in zip(mi, hit):
                    neighbors[a].update(int(j) for j in mj[row] if j > a)
        return [(i, np.asarray(sorted(neighbors[i]), np.int32))
                for i in range(n)]

    # ---------------------------------------------------------- errors
    def has_error(self) -> bool:
        return self._script.last_error is not None

    def get_last_error_message(self):
        err, self._script.last_error = self._script.last_error, None
        return err or ""

    # ------------------------------------------------------------ control
    def run(self, nsteps: int):
        self._ready()
        self.sim.run(nsteps)

    def minimize(self, etol, ftol, maxiter, maxeval):
        self._ready()
        return self.sim.minimize(etol, ftol, maxiter, maxeval)

    def close(self):
        self._script = None
