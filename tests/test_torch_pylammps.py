"""The port's PyLammps (tpumd_torch/pylammps.py) against tpumd's, on the CPU
in f64: every call of tpumd's tests/test_pylammps.py on its deck, through
both packages, the values equal (thermo series to 1e-12)."""

import os

import pytest
import torch

from tpumd.pylammps import PyLammps as JL
from tpumd_torch.pylammps import PyLammps as TL

torch.set_num_threads(2)


def make(pkg):
    L = JL() if pkg == "tpumd" else TL(device="cpu", dtype=torch.float64)
    L.units("lj")
    L.atom_style("atomic")
    L.lattice("fcc", 0.8442)
    L.region("box", "block", 0, 4, 0, 4, 0, 4)
    L.create_box(1, "box")
    L.create_atoms(1, "box")
    L.mass(1, 1.0)
    L.velocity("all", "create", 1.44, 87287, "loop", "geom")
    L.pair_style("lj/cut", 2.5)
    L.pair_coeff(1, 1, 1.0, 1.0, 2.5)
    L.neighbor(0.3, "bin")
    L.fix(1, "all", "nve")
    return L


@pytest.fixture()
def both():
    Ls = {pkg: make(pkg) for pkg in ("tpumd", "port")}
    yield Ls
    for L in Ls.values():
        L.close()


def test_command_dispatch_and_system(both):
    t, j = both["port"].system, both["tpumd"].system
    assert t.natoms == 256 and t.ntypes == 1 and t.units == "lj"
    assert t.xhi > t.xlo
    for k in ("natoms", "ntypes", "units", "atom_style", "nbonds", "xlo",
              "xhi", "ylo", "yhi", "zlo", "zhi", "dimensions"):
        assert getattr(t, k) == pytest.approx(getattr(j, k), rel=1e-15), k


def test_run_captures_thermo(both):
    out = {}
    for pkg, L in both.items():
        L.thermo(5)
        L.run(10)
        assert len(L.runs) == 1
        out[pkg] = L.last_run.thermo
    t, j = out["port"], out["tpumd"]
    assert t.Step == j.Step and t.Step[0] == 0 and t.Step[-1] == 10
    for col in ("Temp", "E_pair", "TotEng", "Press"):
        assert getattr(t, col) == pytest.approx(getattr(j, col), rel=1e-12,
                                                abs=1e-12), col
    assert t.TotEng[-1] == pytest.approx(t.TotEng[0], rel=1e-3)


def test_atoms_view(both):
    out = {}
    for pkg, L in both.items():
        atoms = L.atoms
        a = atoms[0]
        old = a.position
        a.position = (old[0] + 0.01, old[1], old[2])
        out[pkg] = (len(atoms), a.id, a.type, a.mass, old,
                    atoms[0].position, atoms[5].velocity)
    t, j = out["port"], out["tpumd"]
    assert t[:4] == j[:4] == (256, 1, 1, 1.0)
    assert t[5][0] == pytest.approx(t[4][0] + 0.01)
    for a, b in zip(t[4:], j[4:]):
        assert a == pytest.approx(b, rel=1e-15, abs=1e-15)


def test_variables_and_eval(both):
    for L in both.values():
        L.variable("alpha", "equal", "3.0*2")
        v = L.variables["alpha"]
        assert v.style == "equal" and v.value == 6.0
        assert L.eval("v_alpha+1") == 7.0
        assert L.eval("natoms") == 256.0


def test_version_and_history(both, tmp_path):
    for pkg, L in both.items():
        assert L.version() == 20230802
        L.enable_cmd_history = True
        L.thermo(100)
        L.timestep(0.005)
        path = os.path.join(tmp_path, f"{pkg}.in")
        L.write_script(path)
        text = open(path).read()
        assert "thermo 100" in text and "timestep 0.005" in text
