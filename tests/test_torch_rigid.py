"""fix rigid, rigid/nvt, rigid/npt and rigid/nph of the port against the
reference binary and tpumd.

tests/golden/rigid_water, rigid_nvt_water and rigid_npt_water (125 rigid
waters, lj/charmm/coul/long with PPPM) run verbatim through the port on
the CPU in float64, on the cell grid, and through tpumd (float64 on the
CPU): the port's last row holds to the reference binary's thermo.csv at
tests/test_rigid.py's tolerances, and every thermo row to tpumd's at
1e-9 relative (both set the bodies up with numpy's eigh), tpumd's rigid
barostats with PPPM following the box as the port's do.  rigid/nph and
the group bodystyle hold to tpumd the same way; fix rigid single holds
its dof count and conserves momentum and energy as
tests/test_rigid.py:44 has it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.md.fix_rigid import FixRigid, FixRigidNPH
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
COLUMNS = ("temp", "epair", "emol", "etotal", "press", "vol")
# the last row against the reference binary (tests/test_rigid.py:17-125):
# eigh against the reference's Jacobi sweeps, amplified over 20 steps
REF_TOL = {"rigid_water": {"temp": 1e-5, "epair": 1e-5, "etotal": 1e-5,
                           "press": 5e-4, "vol": 1e-9},
           "rigid_nvt_water": {"temp": 1e-5, "epair": 1e-5,
                               "etotal": 1e-5, "press": 5e-4},
           "rigid_npt_water": {"temp": 2e-5, "epair": 2e-5,
                               "etotal": 2e-5, "press": 5e-4,
                               "vol": 1e-7}}


def rows(script):
    """The thermo rows a run printed, as dicts of floats."""
    return [dict(zip(script.sim.thermo_style, map(float, ln.split())))
            for ln in script.sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]


def water_deck(name, tmp_path, fix=None):
    """The golden deck (its fix line replaced by fix, if given) with its
    data file copied into tmp_path."""
    shutil.copy(os.path.join(GOLDEN, name, "data.water"), tmp_path)
    with open(os.path.join(GOLDEN, name, "in.test")) as fh:
        deck = fh.read()
    if fix is not None:
        deck = "\n".join(fix if ln.startswith("fix") else ln
                         for ln in deck.splitlines()) + "\n"
    return deck


def run_both(deck, data_dir):
    """The deck through tpumd and the port.  tpumd's rigid/npt and
    rigid/nph carry no ``pstat``, so tpumd would keep PPPM's coefficients
    at the set-up's box (ROADMAP C13); the flag is set on its fix before
    the run, so that its PPPM follows the box as the port's does."""
    pre, run = deck.rsplit("\nrun", 1)
    j = JScript(data_dir=str(data_dir))
    j.run_string(pre)
    for fx in j.sim.fixes:
        if fx.name in ("rigid/npt", "rigid/nph"):
            fx.pstat = True
    j.run_string("run" + run)
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(data_dir)
    t.run_string(deck)
    return j, t


def assert_rows_equal(j, t, rel=1e-9):
    jr, tr = rows(j), rows(t)
    assert [r["step"] for r in tr] == [r["step"] for r in jr]
    for a, b in zip(tr, jr):
        for k in COLUMNS:
            assert a[k] == pytest.approx(b[k], rel=rel, abs=1e-9), (
                a["step"], k)


@pytest.mark.parametrize("name", sorted(REF_TOL))
def test_rigid_water_golden(name, tmp_path):
    j, t = run_both(water_deck(name, tmp_path), tmp_path)
    sim = t.sim
    assert sim._ctx.is_cellgrid
    fx = sim.fixes[0]
    assert fx.nbody == 125 and fx.dof_removed == 125 * 3
    assert sim.dof() == 3 * 375 - 3 - 375
    v, last = sim.last_thermo, np.loadtxt(
        os.path.join(GOLDEN, name, "thermo.csv"))[-1]
    assert v["step"] == last[0] == 20
    for k, rel in REF_TOL[name].items():
        assert v[k] == pytest.approx(last[1 + COLUMNS.index(k)], rel=rel), k
    assert_rows_equal(j, t)
    # every body stayed rigid: its atoms' distances are the set-up's
    s, _, fstates = sim._carry
    fst = fstates[0]
    x = s.x[sim._carry[1].row2slot].double() + FixRigid._shift(s)[
        sim._carry[1].row2slot]
    xb = x.reshape(125, 3, 3)
    d = torch.linalg.vector_norm(xb[:, :, None] - xb[:, None], dim=-1)
    disp = fst.disp_tag.reshape(125, 3, 3)
    d0 = torch.linalg.vector_norm(disp[:, :, None] - disp[:, None], dim=-1)
    # under the barostat the step ends on the second half dilation, which
    # moves the atoms with the box until the next set_xv
    tol = 1e-5 if name == "rigid_npt_water" else 1e-10
    assert float(torch.max(torch.abs(d - d0))) <= tol * float(d0.max())


@pytest.mark.parametrize("fix", [
    "fix 1 all rigid/npt/small molecule temp 300 320 100 aniso 1 1 1000 "
    "tparam 4 2 5 dilate all",
    "fix 1 all rigid/npt molecule temp 300 300 100 x 1 1 1000 z 2 2 500 "
    "pchain 3",
    "fix 1 all rigid/nve/small molecule"])
def test_rigid_styles_against_tpumd(fix, tmp_path):
    j, t = run_both(water_deck("rigid_npt_water", tmp_path, fix), tmp_path)
    assert t.sim._ctx.is_cellgrid
    assert_rows_equal(j, t)


def test_rigid_nph(tmp_path):
    """rigid/nph: the barostat at the set-up's temperature t0, no chain
    (tpumd's set-up divides 0 by 0 here, ROADMAP C13)."""
    deck = water_deck("rigid_npt_water", tmp_path,
                      "fix 1 all rigid/nph molecule iso 1.0 1.0 1000.0")
    with pytest.raises(ZeroDivisionError):
        JScript(data_dir=str(tmp_path)).run_string(deck)
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    t.run_string(deck)
    fx, fst = t.sim.fixes[0], t.sim._carry[2][0]
    r = rows(t)
    assert isinstance(fx, FixRigidNPH) and not fx.tstat
    assert fx.t0 == pytest.approx(r[0]["temp"], rel=1e-7)
    assert fst.eta_dot_t == (0.0,) * fx.t_chain
    assert r[-1]["vol"] != r[0]["vol"]
    assert all(np.isfinite(list(row.values())).all() for row in r)


SINGLE = """
units lj
atom_style atomic
region box block 0 10 0 10 0 10
create_box 1 box
lattice sc 0.30
create_atoms 1 box
mass 1 1.0
velocity all create 1.0 12345 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
thermo 50
thermo_style custom step temp epair emol etotal press vol
"""


def test_rigid_single_conservation():
    """One body of every atom (tests/test_rigid.py:44): 3N - 6 dof gone,
    its momentum zero over 200 steps, and its rows tpumd's."""
    deck = SINGLE + "fix 1 all rigid single\nrun 200\n"
    j = JScript()
    j.run_string(deck)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    fx = t.sim.fixes[0]
    n = t.sim.natoms
    assert fx.nbody == 1 and fx.dof_removed == 3 * n - 6
    tr, jr = rows(t), rows(j)
    assert len(tr) == 5
    for a, b in zip(tr, jr):
        for k in ("temp", "epair", "etotal"):
            assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-12), k
    fst = t.sim._carry[2][0]
    assert float(torch.abs(fst.vcm).max()) < 1e-12


def test_rigid_group_bodies_against_tpumd():
    deck = (SINGLE + "region left block 0 5 0 10 0 10\n"
            "group left region left\ngroup right subtract all left\n"
            "fix 1 all rigid group 2 left right\nrun 50\n")
    j = JScript()
    j.run_string(deck)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    assert t.sim.fixes[0].nbody == 2
    assert t.sim.fixes[0].dof_removed == j.sim.fixes[0].dof_removed
    for a, b in zip(rows(t), rows(j)):
        for k in ("temp", "epair", "etotal", "press"):
            assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-12), k


def test_rigid_parse():
    t = TScript(device="cpu", dtype=torch.float64)
    for bad, word in (("rigid custom v_x", "bodystyle"),
                      ("rigid molecule langevin 1 1 1 1", "langevin"),
                      ("rigid/nvt molecule temp 1 1 1 reinit no", "reinit")):
        with pytest.raises(NotImplementedError, match=word):
            t._parse_rigid(bad.split()[0], bad.split()[1:])
    fx = t._parse_rigid("rigid/npt", "single temp 1 2 3 x 1 2 3 z 4 5 6 "
                        "pchain 4".split())
    assert fx.p_flag == (True, False, True) and fx.pstyle == "aniso"
    assert fx.p_chain == 4 and fx.t_stop == 2.0
