"""The port's minimize command against tpumd and the reference binary, on
the CPU in f64.

* cg, sd, fire, quickmin and hftn on 4^3 fcc cells displaced at random by
  up to 0.08 sigma (tests/test_breadth_golden.py:163-187's deck): the
  port's ``Minimization:`` line (iterations, converged or not, energies to
  10 digits) equal to tpumd's, the final pe per atom to 1e-12 relative,
  hftn at the reference binary's minimum -6.77336805325271 to 1e-9 and
  quickmin at it to 1e-6 (tpumd's tests' tolerances).
* tests/golden/min_cg: the deck with maxiter 100 in place of 1000 (tpumd's
  and the port's halving line search never fails, so the verbatim deck
  runs all 1000 iterations, ~7,700 force evaluations; chip_smoke.py runs
  it verbatim on the card): etotal equal to efinal.txt to 1e-8 relative.
* ``bench_targets.lattice_pe``, the perfect lattice's energy summed in
  f64, at the reference binary's minimum.
* The f32 gap of ``bench_targets.IN_LJ_MIN32K`` at 4^3 cells (cg, then
  fire from a second displacement): within ``MIN32K_F32_CPU_GAP`` of the
  energy of the lattice in the run's f32 box, the base of the card's f32
  gate.
* min_style and min_modify take only what the port computes with.
"""

import os

import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HEAD = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
displace_atoms all random 0.08 0.08 0.08 76543
"""
# style: minimize arguments (few iterations where tpumd's loop runs to
# maxiter; sd with an etol that ends it)
CASES = {"cg": "0.0 1.0e-8 40 10000", "sd": "1.0e-12 1.0e-8 200 10000",
         "fire": "0.0 1.0e-8 150 10000", "quickmin": "0.0 1.0e-8 150 10000",
         "hftn": "0.0 1.0e-8 2000 20000"}


def _min_line(script):
    return [ln for ln in script.sim.log_lines if ln.startswith(
        "Minimization:")][-1]


@pytest.mark.parametrize("style", sorted(CASES))
def test_minimize_against_tpumd(style):
    deck = HEAD + f"min_style {style}\nminimize {CASES[style]}\n"
    j = JScript()
    j.run_string(deck)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    sim = t.sim
    assert sim._ctx.is_cellgrid
    assert _min_line(t) == _min_line(j)
    pe = sim.last_thermo["pe"]
    assert pe == pytest.approx(j.sim.last_thermo["pe"], rel=1e-12)
    stats = sim.min_stats
    assert stats["style"] == style and stats["evaluations"] > stats[
        "iterations"] > 0
    if style == "hftn":
        assert abs(pe - bt.LATTICE_PE) < 1e-9
    if style == "quickmin":
        assert abs(pe - bt.LATTICE_PE) < 1e-6


def test_min_cg_golden():
    d = os.path.join(GOLDEN, "min_cg")
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = d
    with open(os.path.join(d, "in.test")) as fh:
        deck = fh.read()
    assert "minimize        0.0 1e-8 1000 10000" in deck
    t.run_string(deck.replace("1000 10000", "100 10000"))
    with open(os.path.join(d, "efinal.txt")) as fh:
        e_ref = float(fh.read())
    assert t.sim.last_thermo["etotal"] == pytest.approx(e_ref, rel=1e-8)


def test_lattice_pe():
    """The lattice sum at in.lj's box in f64 is the reference binary's
    minimum (4^3 and 20^3 cells), and the port's f64 energy of the perfect
    lattice at 4^3 cells is the sum's."""
    for n in (4, 20):
        edge = n * (4.0 / 0.8442) ** (1.0 / 3.0)
        assert bt.lattice_pe([edge] * 3, n) == pytest.approx(bt.LATTICE_PE,
                                                             rel=1e-12)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(HEAD.replace("displace_atoms all random 0.08 0.08 0.08 "
                              "76543\n", "") + "run 0\n")
    s = t.sim._carry[0]
    edges = (s.box.hi - s.box.lo).numpy()
    assert t.sim.last_thermo["pe"] == pytest.approx(
        bt.lattice_pe(edges, 4), rel=1e-12)


def test_min_deck_f32_gap():
    """IN_LJ_MIN32K at 4^3 cells in f32: each minimization's pe within
    MIN32K_F32_CPU_GAP of the lattice of its own box (the box rounded to
    f32; bench_targets.lattice_pe), the base of the card's f32 gate.  Its
    final positions in f64: fire's at that lattice to 1e-9 relative; cg's
    line search stops where the f32 energy no longer resolves a descent,
    short of it (printed)."""
    from tpumd_torch.core.state import Box
    from tpumd_torch.ops.lj_cellgrid import lj_cellgrid_plain
    t = TScript(device="cpu", dtype=torch.float32)
    lines = bt.IN_LJ_MIN32K.format(n=4).splitlines()
    cut = lines.index("displace_atoms  all random 0.08 0.08 0.08 12345")
    gaps, conv = [], []
    for part in (lines[:cut], lines[cut:]):
        t.run_string("\n".join(part))
        sim = t.sim
        s, neigh, _ = sim._carry
        box = Box(lo=s.box.lo.double(), hi=s.box.hi.double())
        pe_box = bt.lattice_pe((box.hi - box.lo).numpy(), 4)
        _, e64, _ = lj_cellgrid_plain(s.x.double(), neigh.valid, box,
                                      sim._neigh_cfg, sim.pair.kernel_coeffs(),
                                      1, 0)
        gaps.append(abs(sim.last_thermo["pe"] - pe_box) / abs(pe_box))
        conv.append(abs(float(e64) / sim.natoms - pe_box) / abs(pe_box))
    print(f"IN_LJ_MIN32K n=4 f32 on the CPU: pe/atom gaps to the f32 box's "
          f"lattice {gaps}; the positions' in f64 {conv}")
    assert max(gaps) <= bt.MIN32K_F32_CPU_GAP
    assert conv[1] <= 1e-9


@pytest.mark.parametrize("line,match", [
    ("min_modify dmax 0.2", "dmax"),
    ("min_modify line quadratic", "line"),
    ("min_modify fire/old yes", "fire/old"),
    ("min_style fire/old", "min_style"),
])
def test_min_commands_refuse(line, match):
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(HEAD)
    t.execute("min_modify dmax 0.1 line backtrack integrator eulerimplicit")
    with pytest.raises(NotImplementedError, match=match):
        t.execute(line)
