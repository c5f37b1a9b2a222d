"""The port's embedding API (tpumd_torch/api.py) against tpumd's, on the CPU
in f64: every call of tpumd's tests/test_api_io.py on its deck (4^3 fcc
cells at 0.8442, T 1.44), through both packages, the values equal (arrays
to 1e-12); and the calls that test does not make: extract_global,
extract_box_full, extract_setting, extract_compute, extract_variable,
set_variable, reset_box, create_atoms, neighlist_half, the error state.
"""

import numpy as np
import pytest
import torch

from tpumd.api import TpuMD as JMD
from tpumd_torch.api import TpuMD as TMD

torch.set_num_threads(2)
DECK = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 5 check no
fix             1 all nve
"""
PKGS = ("tpumd", "port")


def make(pkg, tmp_path, deck=DECK):
    md = (JMD(data_dir=str(tmp_path)) if pkg == "tpumd" else
          TMD(device="cpu", dtype=torch.float64, data_dir=str(tmp_path)))
    md.commands_string(deck)
    md.sim.verbose = False
    return md


def arr(a):
    return np.asarray(a, np.float64)


def test_api_basic(tmp_path):
    out = {}
    for pkg in PKGS:
        md = make(pkg, tmp_path)
        md.run(5)
        t1 = md.get_thermo("temp")
        md.scatter_atoms("v", md.gather_atoms("v") * 0.5)
        out[pkg] = dict(n=md.get_natoms(), t1=t1, x=arr(md.gather_atoms("x")),
                        ntypes=md.extract_global("ntypes"),
                        t2=md.get_thermo("temp"),
                        v=arr(np.sort(md.extract_atom("v"), axis=0)),
                        ids=np.sort(np.asarray(md.extract_atom("id"))))
        assert out[pkg]["t2"] == pytest.approx(0.25 * t1, rel=1e-10)
    t, j = out["port"], out["tpumd"]
    assert (t["n"], t["ntypes"]) == (j["n"], j["ntypes"]) == (256, 1)
    assert t["t1"] == pytest.approx(j["t1"], rel=1e-12)
    np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(t["v"], j["v"], rtol=0, atol=1e-12)
    assert (t["ids"] == j["ids"]).all()


def test_dump_and_restart(tmp_path):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        md = make(pkg, d)
        md.command(f"dump 1 all custom 5 {d}/d.txt id type x y z vx fx")
        md.command("dump_modify 1 sort id")
        md.run(5)
        text = open(d / "d.txt").read()
        assert text.count("ITEM: ATOMS") == 2
        md.command(f"write_restart {d}/state.npz")
        e_before, step_before = md.get_thermo("etotal"), md.sim.step
        md2 = (JMD(data_dir=str(d)) if pkg == "tpumd" else
               TMD(device="cpu", dtype=torch.float64, data_dir=str(d)))
        md2.commands_string("""
units           lj
atom_style      atomic
pair_style      lj/cut 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 5 check no
fix             1 all nve
""")
        md2.command(f"read_restart {d}/state.npz")
        md2.command("pair_coeff 1 1 1.0 1.0 2.5")
        md2.sim.verbose = False
        md2.sim.setup()
        assert md2.sim.step == step_before
        assert md2.get_thermo("etotal") == pytest.approx(e_before, rel=1e-12)
        md.run(5)
        md2.run(5)
        for k in ("etotal", "temp"):
            assert md2.get_thermo(k) == pytest.approx(md.get_thermo(k),
                                                      rel=1e-12)
        out[pkg] = (text.splitlines()[9:12], md.get_thermo("etotal"))
    np.testing.assert_allclose(
        [[float(v) for v in ln.split()] for ln in out["port"][0]],
        [[float(v) for v in ln.split()] for ln in out["tpumd"][0]],
        rtol=1e-7, atol=1e-12)
    assert out["port"][1] == pytest.approx(out["tpumd"][1], rel=1e-12)


def test_write_data(tmp_path):
    for pkg in PKGS:
        md = make(pkg, tmp_path)
        md.run(2)
        md.command(f"write_data {tmp_path}/{pkg}.data")
        text = open(tmp_path / f"{pkg}.data").read()
        assert "256 atoms" in text and "Velocities" in text


def test_minimize(tmp_path):
    out = {}
    for pkg in PKGS:
        md = make(pkg, tmp_path, DECK.replace(
            "velocity        all create 1.44 87287 loop geom", ""))
        md.command("run 0")
        rng = np.random.RandomState(0)
        x = md.gather_atoms("x")
        md.scatter_atoms("x", x + rng.uniform(-0.05, 0.05, x.shape))
        e0 = md.get_thermo("pe")
        md.minimize(0.0, 1e-4, 200, 200)
        out[pkg] = (e0, md.get_thermo("pe"), arr(md.gather_atoms("x")))
        assert out[pkg][1] < e0
    t, j = out["port"], out["tpumd"]
    assert t[0] == pytest.approx(j[0], rel=1e-12)
    assert t[1] == pytest.approx(j[1], rel=1e-10)


def test_extract_and_set(tmp_path):
    out = {}
    for pkg in PKGS:
        md = make(pkg, tmp_path, DECK + """
compute ke all ke
compute pea all pe/atom
variable a equal 3.0*2
variable s string hello
""")
        md.run(3)
        lo, hi = md.extract_box()
        box = md.extract_box_full()
        out[pkg] = dict(
            dt=md.extract_global("dt"), step=md.extract_global("ntimestep"),
            lo=arr(lo), hi=arr(hi), box=box[2:6],
            settings=[md.extract_setting(k) for k in (
                "natoms", "ntypes", "dimension", "triclinic", "q_flag",
                "bogus")],
            ke=md.extract_compute("ke", 0, 0),
            pea=np.sort(arr(md.extract_compute("pea", 1, 1))),
            a=md.extract_variable("a"), s=md.extract_variable("s"),
            set=(md.set_variable("s", "world"), md.set_variable("a", 1)),
            s2=md.extract_variable("s"),
            nlist=[(i, js.tolist()) for i, js in md.neighlist_half()])
    t, j = out["port"], out["tpumd"]
    for k in t:
        if isinstance(t[k], np.ndarray):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-12)
        elif isinstance(t[k], float):
            assert t[k] == pytest.approx(j[k], rel=1e-12), k
        else:
            assert t[k] == j[k], k
    assert t["s2"] == "world" and t["set"] == (0, -1)


def test_reset_box_and_create_atoms(tmp_path):
    out = {}
    for pkg in PKGS:
        md = make(pkg, tmp_path, """
units lj
atom_style atomic
region box block 0 10 0 10 0 10
create_box 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
""")
        n = md.create_atoms(4, [4, 3, 2, 1], [1, 1, 1, 1],
                            [1.0, 1.0, 1.0, 2.2, 1.0, 1.0, 1.0, 2.2, 1.0,
                             5.0, 5.0, 5.0], v=[0.01] * 12)
        md.commands_string("fix 1 all nve\nrun 2\n")
        md.reset_box([-1.0, -1.0, -1.0], [11.0, 11.0, 11.0])
        md.run(2)
        out[pkg] = (n, arr(md.gather_atoms("x")), arr(md.extract_box()[1]),
                    md.get_thermo("vol"))
    t, j = out["port"], out["tpumd"]
    assert t[0] == j[0] == 4
    np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(t[2], [11.0] * 3)
    assert t[3] == pytest.approx(j[3]) == 12.0 ** 3


def test_error_state(tmp_path):
    md = make("port", tmp_path)
    assert not md.has_error()
    with pytest.raises(NotImplementedError):
        md.command("bogus_command 1 2")
    assert md.has_error()
    assert "bogus_command" in md.get_last_error_message()
    assert not md.has_error() and md.get_last_error_message() == ""
