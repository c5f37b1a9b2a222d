"""The water goldens through the port, verbatim: tests/golden/water_nve,
water_shake and water_npt (harmonic bonds, CHARMM angles,
lj/charmm/coul/long with the special weights, PPPM 1e-4, SHAKE clusters in
water_shake and water_npt, fix npt iso in water_npt), their velocity, dump
and dump_modify lines included, on the CPU in float64, on neighbor_mode
"auto" (which takes the cell grid for this 19 A box) and "cellgrid".  The
dumped per-atom forces hold to the reference binary's dump.water, and the
last thermo row to its thermo.csv, at the tolerances of
tests/test_golden_water.py:68-92.  rattle_water (fix rattle after fix nve)
holds its last row to thermo.csv at tests/test_rigid.py:87-98's
tolerances.  water_npt replicated 2x2x2 (3,000 atoms, all three axes
moving under iso, PPPM's coefficients recomputed from the box every
evaluation, the list's rebuild check with its box term) holds every thermo
row to tpumd's over 20 steps."""

import os
import shutil

import numpy as np
import pytest
import torch

from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def run_case(name, tmp_path, mode):
    """The deck verbatim in tmp_path (its dump.water lands there, not over
    the fixture); mode "auto" leaves the engine to the port."""
    d = os.path.join(GOLDEN, name)
    shutil.copy(os.path.join(d, "data.water"), tmp_path)
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.data_dir = str(tmp_path)
    with open(os.path.join(d, "in.test")) as fh:
        deck = fh.read()
    pre, runline = deck.rsplit("\nrun", 1)
    script.run_string(pre)
    script.sim.verbose = False
    script.sim.neighbor_mode = mode
    script.run_string("run" + runline)
    return script.sim, np.loadtxt(os.path.join(d, "thermo.csv")), d


def parse_dump(path):
    """{step: (n, cols) array sorted by ID} from a text dump."""
    out = {}
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines):
        assert lines[i].startswith("ITEM: TIMESTEP")
        step, n = int(lines[i + 1]), int(lines[i + 3])
        rows = np.loadtxt(lines[i + 9:i + 9 + n]).reshape(n, -1)
        out[step] = rows[np.argsort(rows[:, 0])]
        i += 9 + n
    return out


@pytest.mark.parametrize("name,mode", [
    (name, mode) for mode in ("auto", "cellgrid")
    for name in ("water_nve", "water_shake", "water_npt")])
def test_water_golden(name, mode, tmp_path):
    sim, ref, fixture = run_case(name, tmp_path, mode)
    assert sim._ctx.is_cellgrid
    ours = parse_dump(tmp_path / "dump.water")
    theirs = parse_dump(os.path.join(fixture, "dump.water"))
    assert sorted(ours) == sorted(theirs) == [0, 10]
    for step in theirs:
        scale = max(1.0, np.abs(theirs[step][:, 1:]).max())
        np.testing.assert_array_equal(ours[step][:, 0], theirs[step][:, 0])
        np.testing.assert_allclose(
            ours[step][:, 1:], theirs[step][:, 1:], atol=2e-4 * scale,
            err_msg=f"{name} per-atom forces differ at step {step}")
    v, last = sim.last_thermo, ref[-1]
    # columns: step temp epair emol etotal press vol
    assert v["step"] == last[0]
    assert v["temp"] == pytest.approx(last[1], rel=2e-5, abs=1e-7)
    assert v["epair"] == pytest.approx(last[2], rel=2e-5)
    assert v["emol"] == pytest.approx(last[3], rel=2e-5, abs=2e-5)
    assert v["etotal"] == pytest.approx(last[4], rel=2e-5)
    assert v["press"] == pytest.approx(last[5], rel=2e-4, abs=0.5)
    assert v["vol"] == pytest.approx(last[6], rel=1e-6)


@pytest.mark.parametrize("mode", ["auto", "cellgrid"])
def test_rattle_water_golden(mode, tmp_path):
    sim, ref, _ = run_case("rattle_water", tmp_path, mode)
    assert sim._ctx.is_cellgrid
    assert [fx.name for fx in sim.fixes] == ["nve", "rattle"]
    assert sim.dof() == 3 * 375 - 3 - 125 * 3
    v, last = sim.last_thermo, ref[-1]
    assert v["step"] == last[0] == 20
    assert v["temp"] == pytest.approx(last[1], rel=1e-5)
    assert v["epair"] == pytest.approx(last[2], rel=1e-5)
    assert v["etotal"] == pytest.approx(last[4], rel=1e-5)
    assert v["press"] == pytest.approx(last[5], rel=5e-4)
    # RATTLE holds the bonds and the angle
    s, neigh, _ = sim._carry
    x = s.x[neigh.row2slot].reshape(125, 3, 3)
    d01 = torch.linalg.vector_norm(x[:, 1] - x[:, 0], dim=-1)
    d02 = torch.linalg.vector_norm(x[:, 2] - x[:, 0], dim=-1)
    assert torch.allclose(d01, torch.full_like(d01, 0.9572), atol=1e-3)
    assert torch.allclose(d02, torch.full_like(d02, 0.9572), atol=1e-3)


def replicated_rows(script, deck):
    script.run_string(deck)
    return [dict(zip(script.sim.thermo_style, map(float, ln.split())))
            for ln in script.sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]


def test_water_npt_replicated_against_tpumd(tmp_path):
    from tpumd.script.parser import LammpsScript as JScript
    d = os.path.join(GOLDEN, "water_npt")
    shutil.copy(os.path.join(d, "data.water"), tmp_path)
    with open(os.path.join(d, "in.test")) as fh:
        deck = [ln for ln in fh.read().splitlines()
                if not ln.startswith(("dump", "run", "thermo "))]
    i = next(k for k, ln in enumerate(deck) if ln.startswith("read_data"))
    deck = "\n".join(deck[:i + 1] + ["replicate 2 2 2"] + deck[i + 1:]
                     + ["thermo 10", "run 20"]) + "\n"
    jr = replicated_rows(JScript(data_dir=str(tmp_path)), deck)
    t = LammpsScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    tr = replicated_rows(t, deck)
    assert t.sim.natoms == 3000 and t.sim._ctx.is_cellgrid
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [0, 10, 20]
    for a, b in zip(tr, jr):
        for k in ("temp", "epair", "emol", "etotal", "press", "vol"):
            assert a[k] == pytest.approx(b[k], rel=1e-8, abs=1e-9), (
                a["step"], k)
    # iso moved all three lengths alike
    box = t.sim.state.box.lengths_np()
    assert box[0] == box[1] == box[2] != 38.0


@pytest.mark.parametrize("name,golden", [("water_npt30k", "water_npt"),
                                         ("rigid_npt30k", "rigid_npt_water")])
def test_water30k_step0_targets(name, golden):
    """The 4x4x5 decks of bench_targets: each is its golden deck with the
    replicate line (and, for water_npt30k, LAMMPS's default fix npt line
    and thermo 50, its dump lines dropped); their step-0 rows on the CPU
    in f64 pass the step-0 gates and are the f64 targets; the geometry
    checks read the set-up's state."""
    from tpumd_torch import bench_targets as bt
    deck = {"water_npt30k": bt.IN_WATER_NPT30K,
            "rigid_npt30k": bt.IN_RIGID_NPT30K}[name]
    d = os.path.join(GOLDEN, golden)
    with open(os.path.join(d, "in.test")) as fh:
        want = [ln for ln in fh.read().strip().splitlines()
                if not ln.startswith(("dump", "run"))]
    if name == "water_npt30k":
        want = [("fix             1 all npt temp 300.0 300.0 100.0 iso 0.0 "
                 "0.0 1000.0") if ln.startswith("fix             1") else
                "thermo          50" if ln.startswith("thermo   ") else ln
                for ln in want]
    want = [ln.replace("data.water", "{golden}/data.water") for ln in want]
    i = want.index("read_data       {golden}/data.water")
    want = want[:i + 1] + ["replicate       4 4 5"] + want[i + 1:]
    assert deck.strip().splitlines() == want
    t = LammpsScript(device="cpu", dtype=torch.float64)
    t.run_string(deck.format(golden=d) + "run 0\n")
    v = t.sim.last_thermo
    assert t.sim.natoms == 30000 and t.sim._ctx.is_cellgrid
    assert not bt.gate_failures(v, bt.WATER30K_STEP0[name])
    for k, ref in bt.WATER30K_STEP0_F64[name].items():
        assert v[k] == pytest.approx(ref, rel=1e-10), k
    if name == "water_npt30k":
        bond, angle = bt.shake_geometry(t.sim)
        # the set-up moved the atoms onto the constraints
        assert bond < 1e-4 and angle < 1e-4
    else:
        assert bt.rigid_geometry(t.sim) < 1e-12
