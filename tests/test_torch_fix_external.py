"""The port's fix external (md/fix_external.py) through its API, against
fix addforce and fix spring/self and against tpumd's API, on the CPU in
f64 (tests/test_fix_external.py's four cases and deck).

* pf/array: a constant force written into the caller's buffer between runs
  equals fix addforce's trajectory to 1e-12.
* pf/callback 1 1: the callback's -k (x - x0) (the displacement taken to
  the nearest image, since x is wrapped) equals fix spring/self's
  trajectory to 1e-11; tpumd's API with the same callback gives the same
  positions.
* pf/callback 5 1 fires at steps 0, 5 and 10 of a 12-step run; each
  callback is one host read of x.
* The caller's global energy is the fix's scalar (extract_fix).
* On the cell grid, where a re-bin permutes the rows, a force that depends
  on the atom's ID lands on that atom: the port's positions after 40 steps
  and 8 re-bins equal tpumd's (on its matrix engine, whose rows stay put)
  to 1e-10.
"""

import numpy as np
import pytest
import torch

from tpumd.api import TpuMD as JMD
from tpumd_torch.api import TpuMD as TMD

torch.set_num_threads(2)
DECK = """
units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 {n} 0 {n} 0 {n}
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.44 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
neigh_modify delay 0 every 5 check no
fix 1 all nve
"""


def make(pkg, extra, hook=None, nsteps=0, n=3):
    lmp = (JMD() if pkg == "tpumd"
           else TMD(device="cpu", dtype=torch.float64))
    lmp.commands_string(DECK.format(n=n) + extra)
    lmp.sim.verbose = False
    if hook:
        hook(lmp)
    lmp.run(nsteps)
    return lmp


def spring_cb(k):
    x0 = {}

    def cb(caller, step, nlocal, ids, x, fext):
        if not x0:
            x0["x"] = x.copy()
        d = x - x0["x"]
        ell = 3 * (4 / 0.8442) ** (1 / 3)
        fext[:] = -k * (d - ell * np.round(d / ell))
    return cb


def test_pf_array_matches_addforce():
    ref = make("port", "fix ext all addforce 0.11 -0.23 0.05\n", nsteps=20)

    def hook(lmp):
        lmp.command("run 0")
        lmp.fix_external_get_force("ext")[:] = [0.11, -0.23, 0.05]
    got = make("port", "fix ext all external pf/array 1\n", hook, 20)
    np.testing.assert_allclose(got.gather_atoms("x"), ref.gather_atoms("x"),
                               rtol=0, atol=1e-12)


def test_pf_callback_matches_spring_self():
    k = 0.7
    ref = make("port", f"fix ext all spring/self {k}\n", nsteps=25)
    got = {}
    for pkg in ("tpumd", "port"):
        got[pkg] = make(pkg, "fix ext all external pf/callback 1 1\n",
                        lambda lmp: lmp.set_fix_external_callback(
                            "ext", spring_cb(k)), 25)
    t = got["port"]
    for name in ("x", "v"):
        np.testing.assert_allclose(t.gather_atoms(name),
                                   ref.gather_atoms(name), rtol=0,
                                   atol=1e-11)
        np.testing.assert_allclose(t.gather_atoms(name),
                                   got["tpumd"].gather_atoms(name), rtol=0,
                                   atol=1e-11)
    # 25 steps and the set-up: one read of x each
    assert t._find_external("ext").reads == 26


def test_pf_callback_every_n():
    calls = {}
    for pkg in ("tpumd", "port"):
        seen = calls[pkg] = []

        def cb(caller, step, nlocal, ids, x, fext, seen=seen):
            seen.append(step)
            fext[:, 0] = 0.01
        got = make(pkg, "fix ext all external pf/callback 5 1\n",
                   lambda lmp: lmp.set_fix_external_callback("ext", cb), 12)
        assert got.get_thermo("step") == 12
    assert calls["port"] == calls["tpumd"] == [0, 5, 10]


def test_energy_and_virial_global():
    got = make("port", "fix ext all external pf/array 1\n",
               lambda lmp: lmp.fix_external_set_energy_global("ext", 3.25))
    assert got.extract_fix("ext", 0, 0) == pytest.approx(3.25)


def test_forces_land_by_tag_after_rebins():
    def cb(caller, step, nlocal, ids, x, fext):
        fext[:] = 0.02 * ((ids % 7) - 3.0)[:, None] * np.array(
            [1.0, -0.5, 0.25])
    out = {}
    for pkg in ("tpumd", "port"):
        out[pkg] = make(pkg, "fix ext all external pf/callback 1 1\n",
                        lambda lmp: lmp.set_fix_external_callback("ext", cb),
                        40, n=4)
    t = out["port"]
    assert t.sim._ctx.is_cellgrid and t.sim._carry[1].nbuilds >= 8
    np.testing.assert_allclose(t.gather_atoms("x"),
                               out["tpumd"].gather_atoms("x"), rtol=0,
                               atol=1e-10)
