"""The water goldens through the port, verbatim: tests/golden/water_nve
and water_shake (harmonic bonds, CHARMM angles, lj/charmm/coul/long with
the special weights, PPPM 1e-4, SHAKE clusters in water_shake), their
velocity, dump and dump_modify lines included, on the CPU in float64, on
neighbor_mode "auto" (which takes the cell grid for this 19 A box) and
"cellgrid".  The dumped per-atom forces hold to the reference binary's
dump.water, and the last thermo row to its thermo.csv, at the tolerances
of tests/test_golden_water.py:68-92.  water_npt waits for fix npt iso."""

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
    ("water_nve", "auto"), ("water_shake", "auto"),
    ("water_nve", "cellgrid"), ("water_shake", "cellgrid")])
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
