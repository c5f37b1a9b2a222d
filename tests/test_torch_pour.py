"""Atom insertion and deletion against tpumd: fix pour, deposit, evaporate.

* fix pour (tests/golden/gran/in.pour): the port's insertions equal
  tpumd's bit for bit (RanPark stream with its warm-up draws, the C-order
  nper and nfreq, the overlap test against the atoms near the region):
  the first batch at the first run's start and the second at step 107,
  positions, velocities, radii and masses by tag; the atom counts of
  every thermo row equal.  tpumd runs its matrix engine, the port the
  grid ("auto"): the overlap test sees the same atoms to roundoff.
* A crowded insertion that runs out of attempts:
  tests/test_torch_pour_crowded.py.
* fix deposit and fix evaporate on a small lj/cut deck, both packages on
  the matrix engine (evaporate picks atoms by their row): the same atoms
  are added and deleted at each event, a deposited atom lands where
  tpumd's does bit for bit, and the thermo rows agree.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.md.fix_pour import FixPour
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

POUR = (Path(__file__).parent / "golden" / "gran" / "in.pour").read_text(
).split("run")[0]


def _by_tag(s, keys=("x", "v", "radius", "rmass")):
    tag = np.asarray(s.tag if not isinstance(s.tag, torch.Tensor)
                     else s.tag.numpy())
    live = tag > 0
    order = np.argsort(tag[live])
    out = {"tag": tag[live][order]}
    for k in keys:
        a = getattr(s, k)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out[k] = a[live][order]
    return out


def _counts(log_lines):
    return [ln.split()[:2] for ln in log_lines
            if ln.split() and ln.split()[0].isdigit()]


def test_pour_insertions_equal_tpumd():
    j = JScript()
    j.run_string(POUR + "run 0\n")
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(POUR + "run 0\n")
    fx = [f for f in t.sim.fixes if isinstance(f, FixPour)][0]
    assert (fx.nper, fx.nfreq) == (23, 107)
    a, b = _by_tag(t.sim.state), _by_tag(j.sim.state)
    assert len(a["tag"]) == len(b["tag"]) == 48
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    j.run_string("run 107")
    t.run_string("run 107")
    a, b = _by_tag(t.sim.state), _by_tag(j.sim.state)
    assert len(a["tag"]) == len(b["tag"]) == 65
    new = a["tag"] > 48
    for k in a:
        np.testing.assert_array_equal(a[k][new], b[k][new], err_msg=k)
        np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-10,
                                   err_msg=k)
    assert _counts(t.sim.log_lines) == _counts(j.sim.log_lines)
    assert t.sim._mode == "cellgrid"


DEPOSIT = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 5 0 5 0 5
create_box      1 box
region          low block 0 5 0 5 0 2.4
create_atoms    1 region low
mass            1 1.0
velocity        all create 1.0 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 1 check yes
region          top block 0 5 0 5 3.5 4.8
region          mid block 0 5 0 5 0.5 1.5
fix             1 all nve
fix             2 all deposit 6 1 5 4123 region top vz -0.5 -0.2 near 0.9
fix             3 all evaporate 10 4 mid 5555
thermo          5
"""


def test_deposit_and_evaporate_equal_tpumd():
    j = JScript()
    j.run_string(DEPOSIT)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(DEPOSIT)
    t.sim.neighbor_mode = "matrix"
    n0 = t.sim.natoms
    for _ in range(4):
        j.run_string("run 5")
        t.run_string("run 5")
        a, b = _by_tag(t.sim.state, ("x",)), _by_tag(j.sim.state, ("x",))
        np.testing.assert_array_equal(a["tag"], b["tag"])
        np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=1e-10)
        # the atom deposited at this step, where it was put
        assert a["tag"][-1] == n0 + t.sim.step // 5
        np.testing.assert_array_equal(a["x"][-1], b["x"][-1])
    assert t.sim.step == 20
    # four deposited, four deleted at steps 10 and 20 each
    assert len(a["tag"]) == n0 + 4 - 8
    for k in ("temp", "epair", "etotal", "press"):
        assert t.sim.last_thermo[k] == pytest.approx(j.sim.last_thermo[k],
                                                     rel=1e-9), k
    assert _counts(t.sim.log_lines) == _counts(j.sim.log_lines)
