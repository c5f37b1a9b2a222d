"""fix move, fix deform, compute temp/deform and ``dimension 2`` of the
port, on the CPU in f64.

* tests/golden/fix_move (wiggle, linear, rotate and variable on a lower
  slab, nve on the rest) and tests/golden/deform (x scale 1.1, y scale
  0.95, remap x) verbatim on the cell grid against the reference binary's
  thermo.csv at rtol 2e-6 (tpumd's tolerance in tests/test_fix_move.py):
  every row, deform's included, whose energies are those of the force
  evaluation before the step's box move.  The deform golden in f32 on
  the CPU: its gap to those rows, the base of the card's f32 gate on
  IN_DEFORM32K.
* A 2-D deck (``dimension 2``, a hex lattice, fix enforce2d; the box one
  lattice cell deep in z, so the matrix engine with its image copies) and
  a 3-D deck under fix deform x erate and z vel with compute temp/deform
  in its thermo (on the matrix engine, which rebuilds, and so wraps the
  positions that temp/deform reads, at tpumd's steps), each through tpumd
  and the port: every 10th step's thermo to 1e-10 relative; in 2-D z
  forces and velocities 0.
* fix move's x0 through re-bins: a group moved linearly on all three
  axes sits, by tag, at x0 + v t after 40 steps that re-binned the grid,
  and fix move's x0 and spring/self's anchors read back by tag equal the
  positions at the fix's set-up.
"""

import os

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("name,ncol", [("fix_move", 5), ("deform", 10)])
def test_golden_verbatim(name, ncol):
    d = os.path.join(GOLDEN, name)
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = d
    with open(os.path.join(d, "in.test")) as fh:
        t.run_string(fh.read())
    assert t.sim._ctx.is_cellgrid
    rows = bt.golden_rows(t.sim.log_lines, ncol)
    for ref in np.atleast_2d(np.loadtxt(os.path.join(d, "thermo.csv"))):
        step = int(ref[0])
        assert step in rows, f"missing thermo at step {step}"
        np.testing.assert_allclose(rows[step][1:], ref[1:], rtol=2e-6,
                                   atol=1e-8, err_msg=f"step {step}")


DECK_2D = """units lj
dimension 2
atom_style atomic
lattice hex 0.8
region box block 0 10 0 6 -0.5 0.5
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.0 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
neigh_modify every 1 delay 0 check yes
fix 1 all nve
fix 2 all enforce2d
thermo_style custom step temp epair etotal press
"""
DECK_DEFORM = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.2 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
neigh_modify every 1 delay 0 check yes
fix 1 all nve
fix 2 all deform 1 x erate 0.05 z vel -0.2 remap x units box
compute td all temp/deform
thermo_style custom step temp epair etotal press vol lx lz c_td
"""


@pytest.mark.parametrize("deck,cols", [
    ("2d", ("temp", "epair", "etotal", "press")),
    ("deform", ("temp", "epair", "etotal", "press", "vol", "lx", "lz",
                "c_td"))])
def test_deck_against_tpumd(deck, cols):
    text = DECK_2D if deck == "2d" else DECK_DEFORM
    j = JScript()
    t = TScript(device="cpu", dtype=torch.float64)
    j.run_string(text)
    t.run_string(text)
    sim = t.sim
    if deck == "deform":
        # temp/deform reads the positions as stored, which a rebuild
        # wraps: the matrix engine rebuilds at tpumd's steps
        sim.neighbor_mode = "matrix"
    for _ in range(3):
        j.run_string("run 10")
        t.run_string("run 10")
        jr, tr = j.sim.last_thermo, sim.last_thermo
        for k in cols:
            assert tr[k] == pytest.approx(jr[k], rel=1e-10, abs=1e-12), (
                k, tr["step"])
    s = sim._carry[0]
    if deck == "2d":
        # one lattice cell deep in z: the matrix engine's image copies
        assert sim.dimension == 2 and not sim._ctx.is_cellgrid
        assert float(s.v[:, 2].abs().max()) == 0.0
        assert float(s.f[:, 2].abs().max()) == 0.0
    else:
        # the deformation's streaming velocity is taken out
        assert tr["c_td"] != pytest.approx(tr["temp"], rel=1e-4)


def _by_tag(s, a):
    """a (N, ...) of the live slots of s, in tag order."""
    live = s.tag > 0
    order = torch.argsort(s.tag[live])
    return a[live][order]


def test_fix_move_x0_survives_rebins():
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string("""units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 5 0 5 0 5
create_box 1 box
create_atoms 1 box
mass 1 1.0
region slab block INF INF INF INF INF 1.5
group slab region slab
group rest subtract all slab
velocity all create 2.0 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.1 bin
neigh_modify every 1 delay 0 check yes
fix 1 rest nve
fix 2 slab move linear 0.4 -0.3 0.2 units box
fix 3 rest spring/self 1.0
run 0
""")
    sim = t.sim
    s0 = sim._carry[0]
    x_start = _by_tag(s0, s0.x + s0.image.double() * s0.box.lengths)
    move, spring = sim.fixes[1], sim.fixes[2]
    for fx in (move, spring):
        np.testing.assert_array_equal(
            _by_tag(s0, s0.peratom[fx.history_key]).numpy(),
            x_start.numpy())
    t.run_string("run 40")
    s = sim._carry[0]
    assert int(sim._carry[1].nbuilds) > 3, "the grid did not re-bin"
    gm = _by_tag(s, s.gmask)
    slab = (gm & sim.groups["slab"]) > 0
    xu = _by_tag(s, s.x + s.image.double() * s.box.lengths)
    want = x_start + torch.tensor([0.4, -0.3, 0.2],
                                  dtype=torch.float64) * 40 * sim.dt
    np.testing.assert_allclose(xu[slab].numpy(), want[slab].numpy(),
                               rtol=0, atol=1e-12)
    for fx in (move, spring):
        np.testing.assert_array_equal(
            _by_tag(s, s.peratom[fx.history_key]).numpy(),
            x_start.numpy())


def test_deform_f32_gap():
    """The f32 run of the deform golden on the CPU: each column's gap to
    the reference binary's rows (``replicated_gaps``) within
    ``bench_targets.DEFORM_F32_CPU_GAP``, the base of the card's f32 gate
    on the replicated deck."""
    d = os.path.join(GOLDEN, "deform")
    t = TScript(device="cpu", dtype=torch.float32)
    with open(os.path.join(d, "in.test")) as fh:
        t.run_string(fh.read())
    cols = t.sim.thermo_style[1:]
    rows = bt.golden_columns(t.sim.log_lines, cols)
    gaps = bt.replicated_gaps(rows, np.loadtxt(os.path.join(d, "thermo.csv")),
                              cols)
    print(f"deform f32 on the CPU: gaps {gaps}")
    for c, g in gaps.items():
        assert g <= bt.DEFORM_F32_CPU_GAP[c], (c, g)
