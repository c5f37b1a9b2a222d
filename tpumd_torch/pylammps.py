"""PyLammps-style object-oriented wrapper over the embedding API.

The port of tpumd/pylammps.py, the reference's high-level Python interface
(python/lammps/pylammps.py:405 `class PyLammps`): every LAMMPS command
becomes a method (``L.lattice("fcc", 0.8442)``), runs record their thermo
series in ``L.runs``, and ``L.atoms`` / ``L.system`` / ``L.variables`` give
object views over the live simulation.  Backed by
:class:`tpumd_torch.api.TpuMD` (on the card unless ``device="cpu"``)
instead of a shared library handle.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np


class Variable:
    """python/lammps/pylammps.py:68 — live view of a script variable."""

    def __init__(self, pylmp, name):
        self._pylmp = pylmp
        self.name = name

    @property
    def style(self):
        vars_ = self._pylmp.lmp._script.variables
        return vars_[self.name][0]

    @property
    def value(self):
        return self._pylmp.lmp.extract_variable(self.name)

    @value.setter
    def value(self, new):
        if self.style in ("string", "index"):
            self._pylmp.lmp.set_variable(self.name, str(new))
        else:
            self._pylmp.variable(f"{self.name} delete")
            self._pylmp.variable(f"{self.name} equal {new}")

    def __repr__(self):
        return f"Variable(name={self.name!r}, value={self.value!r})"


class Atom:
    """python/lammps/pylammps.py:146 — one atom, tag-order index."""

    def __init__(self, pylmp, index):
        self._pylmp = pylmp
        self.index = index

    def _get(self, name):
        return np.asarray(self._pylmp.lmp.gather_atoms(name))[self.index]

    def _set(self, name, value):
        lmp = self._pylmp.lmp
        arr = np.asarray(lmp.gather_atoms(name)).copy()
        arr[self.index] = value
        lmp.scatter_atoms(name, arr)

    @property
    def id(self):
        return int(self._get("id"))

    @property
    def type(self):
        return int(self._get("type"))

    @property
    def mol(self):
        return int(self._get("molecule"))

    @property
    def mass(self):
        sim = self._pylmp.lmp.sim
        masses = np.asarray(sim.mass, np.float64)
        return float(masses[self.type])

    @property
    def charge(self):
        return float(self._get("q"))

    @property
    def position(self):
        return tuple(float(v) for v in self._get("x"))

    @position.setter
    def position(self, value):
        self._set("x", np.asarray(value, np.float64))

    @property
    def velocity(self):
        return tuple(float(v) for v in self._get("v"))

    @velocity.setter
    def velocity(self, value):
        self._set("v", np.asarray(value, np.float64))

    @property
    def force(self):
        return tuple(float(v) for v in self._get("f"))

    def __dir__(self):
        return ["id", "type", "mol", "mass", "charge", "position",
                "velocity", "force"]


class AtomList:
    """python/lammps/pylammps.py:109 — lazily indexed atom view."""

    def __init__(self, pylmp):
        self._pylmp = pylmp
        self._n = int(pylmp.lmp.get_natoms())

    def __len__(self):
        return self._n

    def __getitem__(self, index):
        if not 0 <= index < self._n:
            raise IndexError(index)
        return Atom(self._pylmp, index)

    def __iter__(self):
        for i in range(self._n):
            yield Atom(self._pylmp, i)


class PyLammps:
    """The OO command interface (python/lammps/pylammps.py:405).

    Every unknown attribute becomes a LAMMPS command:

        L = PyLammps()
        L.units("lj")
        L.lattice("fcc", 0.8442)
        L.run(100)
        print(L.runs[-1].thermo.TotEng[-1])
    """

    def __init__(self, name="", cmdargs=None, ptr=None, verbose=False,
                 device="cuda", dtype=None):
        from tpumd_torch.api import TpuMD
        if ptr is not None:
            self.lmp = ptr.lmp if isinstance(ptr, PyLammps) else ptr
        else:
            self.lmp = TpuMD(device=device, **(
                {} if dtype is None else {"dtype": dtype}))
        self.verbose = verbose
        self.runs = []
        self._cmd_history = []
        self.enable_cmd_history = False

    # ------------------------------------------------------------ admin
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self.lmp:
            self.lmp.close()
        self.lmp = None

    def version(self):
        from tpumd_torch.capi import bridge
        return bridge.version()

    def file(self, path):
        self.lmp.file(path)

    def command(self, cmd):
        if self.enable_cmd_history:
            self._cmd_history.append(cmd)
        self.lmp.command(cmd)

    def write_script(self, filepath):
        """Write all history-recorded commands as a script file."""
        with open(filepath, "w") as fh:
            for cmd in self._cmd_history:
                fh.write(cmd + "\n")

    def clear_cmd_history(self):
        self._cmd_history = []

    # ------------------------------------------------------- run capture
    def run(self, *args, **kwargs):
        """run command that records the per-stop thermo series of the
        segment into ``self.runs`` (reference records via the PYTHON
        package's end_of_step callback; here the engine's thermo log is
        read back directly)."""
        sim = self.lmp.sim
        mark = len(sim.thermo_rows)
        out = self.__getattr__("run")(*args, **kwargs)
        rows = sim.thermo_rows[mark:]
        if not rows and sim.last_thermo:
            rows = [sim.last_thermo]
        series: dict = {}
        for row in rows:
            for k, v in row.items():
                series.setdefault(_thermo_title(k), []).append(float(v))
        thermo = namedtuple("ThermoData", series.keys())(*series.values())
        self.runs.append(namedtuple("Run", ["thermo"])(thermo))
        return out

    @property
    def last_run(self):
        return self.runs[-1] if self.runs else None

    # ------------------------------------------------------------ views
    @property
    def atoms(self):
        return AtomList(self)

    @property
    def system(self):
        sim = self.lmp.sim
        lo, hi = self.lmp.extract_box()
        d = {
            "units": sim.units.name,
            "atom_style": self.lmp._script.atom_style,
            "natoms": int(sim.natoms),
            "ntypes": int(sim.ntypes),
            "nbonds": len(sim.topology.get("bond", ())),
            "nangles": len(sim.topology.get("angle", ())),
            "ndihedrals": len(sim.topology.get("dihedral", ())),
            "nimpropers": len(sim.topology.get("improper", ())),
            "xlo": float(lo[0]), "ylo": float(lo[1]), "zlo": float(lo[2]),
            "xhi": float(hi[0]), "yhi": float(hi[1]), "zhi": float(hi[2]),
            "dimensions": sim.dimension,
        }
        return namedtuple("System", d.keys())(*d.values())

    @property
    def variables(self):
        script = self.lmp._script
        return {name: Variable(self, name) for name in script.variables}

    def eval(self, expr):
        """Evaluate a thermo/variable expression string
        (PyLammps.eval -> lmp_print in the reference)."""
        import torch
        from tpumd_torch.script.formula import Formula, SimFormulaContext
        script = self.lmp._script
        f = Formula(script.substitute(expr))
        out = f.evaluate(SimFormulaContext(script.sim, script))
        if torch.is_tensor(out):
            out = out.detach().cpu().double().numpy()
        return float(out) if np.ndim(out) == 0 else np.asarray(out)

    # --------------------------------------------------- command magic
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def handler(*args, **kwargs):
            cmd_args = [name] + [str(a) for a in args]
            self.command(" ".join(cmd_args))

        return handler

    def __dir__(self):
        return sorted(set(
            list(super().__dir__()) +
            ["units", "lattice", "region", "create_box", "create_atoms",
             "mass", "pair_style", "pair_coeff", "velocity", "fix",
             "unfix", "compute", "uncompute", "variable", "thermo",
             "thermo_style", "timestep", "minimize", "neighbor",
             "neigh_modify", "group", "dump", "undump", "write_restart",
             "read_restart", "read_data", "write_data"]))


# thermo key -> reference column title (PyLammps exposes the LAMMPS
# thermo titles: TotEng, PotEng, E_pair, ...)
_TITLES = {
    "etotal": "TotEng", "pe": "PotEng", "ke": "KinEng", "temp": "Temp",
    "press": "Press", "epair": "E_pair", "emol": "E_mol",
    "ebond": "E_bond", "eangle": "E_angle", "edihed": "E_dihed",
    "eimp": "E_impro", "evdwl": "E_vdwl", "ecoul": "E_coul",
    "elong": "E_long", "etail": "E_tail", "vol": "Volume",
    "density": "Density", "step": "Step", "atoms": "Atoms",
    "enthalpy": "Enthalpy", "cpu": "CPU",
}


def _thermo_title(key):
    return _TITLES.get(key, key)


class IPyLammps(PyLammps):
    """Notebook-flavored subclass (python/lammps/pylammps.py IPyLammps);
    image/video helpers degrade to writing dump files here."""

    def image(self, filename="snapshot.ppm", group="all", size=(512, 512)):
        self.command(f"write_dump {group} image {filename} type type")
        return filename
