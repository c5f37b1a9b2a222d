"""The granular golden decks through the port's LammpsScript, on the CPU in
f64.

* tests/golden/gran: in.granwall, in.granhertz, in.granhooke and in.pour
  run verbatim ("auto": the grid, gran/hooke on the matrix engine) and end
  within rel 2e-6 of the reference binary's logs (ke and c_rot; pour:
  atoms and ke), as tests/test_gran_wall.py holds tpumd;
  tests/golden/wall_lj93 (lj/cut with wall/lj93 on both z faces, the
  matrix engine) holds to its thermo.csv at rel 1e-7, as
  tests/test_breadth_golden.py holds tpumd.
* The same decks over 300 steps (past the first contacts) in the port and
  in tpumd, both on the matrix engine (tpumd's choice on the CPU, ROADMAP
  C2): the rows agree to 1e-9 relative; gran/hertz/history on the grid
  agrees with the matrix engine.
* The contact and wall histories survive a dropped set-up (a group
  command between two runs): the next set-up holds them by tag, entry for
  entry.
"""

import os
import re

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GRAN = os.path.join(GOLDEN, "gran")


def _deck(name):
    return open(os.path.join(GRAN, f"in.{name}")).read()


def _ref_rows(name):
    """{step: (values...)} of the reference log's thermo table."""
    rows, grab = {}, False
    for ln in open(os.path.join(GRAN, f"log.{name}")):
        if re.match(r"\s*Step\s", ln):
            grab = True
            continue
        parts = ln.split()
        if grab and parts and all(re.match(r"-?[\d.eE+-]+$", p)
                                  for p in parts):
            rows[int(parts[0])] = [float(p) for p in parts[1:]]
        elif grab:
            grab = False
    return rows


def _port(text, mode=None, run=None):
    t = TScript(device="cpu", dtype=torch.float64)
    if run is not None:
        text = text.split("run")[0]
    t.run_string(text)
    t.sim.verbose = False
    if mode is not None:
        t.sim.neighbor_mode = mode
    if run is not None:
        t.run_string(f"run {run}")
    return t.sim


@pytest.mark.parametrize("deck", ["granwall", "granhertz", "granhooke",
                                  "pour"])
def test_gran_golden(deck):
    sim = _port(_deck(deck))
    rows = _ref_rows(deck)
    last = rows[max(rows)]
    assert sim.step == max(rows)
    v = sim.last_thermo
    if deck == "pour":
        assert sim.natoms == int(last[0])
        assert v["ke"] == pytest.approx(last[1], rel=2e-6)
        assert sim._mode == "cellgrid"
        return
    assert sim._mode == ("matrix" if deck == "granhooke" else "cellgrid")
    assert v["ke"] == pytest.approx(last[0], rel=2e-6, abs=1e-9)
    assert v["c_rot"] == pytest.approx(last[1], rel=2e-6, abs=1e-9)


def test_wall_lj93_golden():
    d = os.path.join(GOLDEN, "wall_lj93")
    sim = _port(open(os.path.join(d, "in.test")).read())
    ref = np.loadtxt(os.path.join(d, "thermo.csv"))[-1]
    v, rel = sim.last_thermo, 1e-7
    assert sim._mode == "matrix" and sim.step == int(ref[0])
    assert v["temp"] == pytest.approx(ref[1], rel=rel, abs=1e-10)
    assert v["epair"] == pytest.approx(ref[2], rel=rel)
    assert v["emol"] == pytest.approx(ref[3], rel=rel, abs=1e-7)
    assert v["etotal"] == pytest.approx(ref[4], rel=rel)
    assert v["press"] == pytest.approx(ref[5], rel=10 * rel, abs=1e-6)


@pytest.mark.parametrize("deck", ["granwall", "granhertz", "granhooke",
                                  "pour"])
def test_gran_deck_matches_tpumd(deck):
    text = _deck(deck).split("run")[0]
    j = JScript()
    j.run_string(text + "run 300\n")
    sim = _port(text, mode="matrix", run=300)
    keys = ["ke"] + (["c_rot"] if "c_rot" in text else ["atoms"])
    for k in keys:
        assert sim.last_thermo[k] == pytest.approx(j.sim.last_thermo[k],
                                                   rel=1e-9, abs=1e-12), k
    if deck == "granhertz":
        grid = _port(text, mode="cellgrid", run=300)
        for k in keys:
            assert grid.last_thermo[k] == pytest.approx(
                sim.last_thermo[k], rel=1e-9, abs=1e-12), k


def _histories(sim):
    """{tag: (its contact history as sorted (partner tag, shear) pairs,
    its wall histories)} of a set-up simulation."""
    s, neigh, _ = sim._carry
    tag = s.tag
    if sim._ctx.is_cellgrid:
        ptags = neigh.shear_tags
    else:
        own = torch.arange(tag.shape[0])[:, None]
        ptags = torch.where(neigh.idx != own, tag[neigh.idx], 0)
    walls = sorted(k for k in s.peratom if "wall/gran" in k)
    out = {}
    for i in torch.nonzero(tag > 0).flatten().tolist():
        live = ptags[i] > 0
        pair = sorted(zip(ptags[i][live].tolist(),
                          map(tuple, neigh.shear[i][live].tolist())))
        out[int(tag[i])] = (pair, [tuple(s.peratom[k][i].tolist())
                                   for k in walls])
    return out


@pytest.mark.parametrize("mode", ["cellgrid", "matrix"])
def test_histories_survive_a_new_setup(mode):
    """granhertz at step 300 (pair and zcylinder/zplane wall histories
    live): a group command drops the set-up; the next set-up takes both
    histories back by tag, as they were."""
    text = _deck("granhertz").split("run")[0]
    split = _port(text, mode=mode, run=300)
    before = _histories(split)
    assert sum(len(p) for p, _ in before.values()) > 50
    assert sum(any(w) for _, ws in before.values() for w in ws) > 20
    split.script.run_string("group top type 1\nrun 0")
    assert _histories(split) == before
    split.script.run_string("run 100")
    rows = _ref_rows("granhertz")
    # the new set-up re-evaluates the slipping wall contacts from their
    # rescaled history, as the reference's setup does: not bit for bit
    assert split.last_thermo["ke"] == pytest.approx(rows[400][0], rel=1e-3)


def test_granhertz32k_step0_gate():
    """The 32,474-sphere silo on the CPU in f64: step 0 holds to the
    analytic ke (velocity set in lattice units, mass pi/6) and c_rot 0,
    on the grid with the HERTZ coefficients."""
    from tpumd_torch.bench_targets import GRANHERTZ32K_N, IN_GRANHERTZ32K, \
        granhertz32k_gate
    sim = _port(IN_GRANHERTZ32K + "run 0\n")
    assert sim.natoms == GRANHERTZ32K_N and sim._mode == "cellgrid"
    assert sim.pair.kernel_coeffs().hertz
    assert granhertz32k_gate(sim.last_thermo, 0) == []


def test_pour20k_insertion_schedule():
    """pour20k's fix pour: 12,000 spheres an insertion at most, every 416
    steps (the default dt at the fix's definition, as in the golden), on
    a floor of 1,600 spheres."""
    from tpumd_torch.bench_targets import IN_POUR20K
    from tpumd_torch.md.fix_pour import FixPour
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(IN_POUR20K)
    t._finalize_atoms()
    fx = [f for f in t.sim.fixes if isinstance(f, FixPour)][0]
    assert (fx.nper, fx.nfreq, t.sim.natoms) == (12000, 416, 1600)


@pytest.mark.slow
def test_granhertz32k_targets_from_tpumd():
    """bench_targets' tpumd rows of the silo, regenerated by tpumd on the
    CPU in f64 (its matrix engine), and the port's own f64 and f32 runs
    against them (~6 min)."""
    from tpumd_torch.bench_targets import GRANHERTZ32K_TPUMD, \
        IN_GRANHERTZ32K, granhertz32k_gate
    j = JScript()
    j.run_string(IN_GRANHERTZ32K + "run 100\n")
    rows = {100: dict(j.sim.last_thermo)}
    j.run_string("run 400")
    rows[500] = dict(j.sim.last_thermo)
    for step, want in GRANHERTZ32K_TPUMD.items():
        for k, v in want.items():
            assert rows[step][k] == pytest.approx(v, rel=1e-12, abs=0), k
    port = {}
    for dtype in (torch.float64, torch.float32):
        t = TScript(device="cpu", dtype=dtype)
        t.run_string(IN_GRANHERTZ32K + "run 100\n")
        got = {100: dict(t.sim.last_thermo)}
        t.run_string("run 400")
        got[500] = dict(t.sim.last_thermo)
        for step in (100, 500):
            assert granhertz32k_gate(got[step], step, port.get(step)) == []
        port = port or got


@pytest.mark.slow
def test_pour20k_targets_from_the_port():
    """bench_targets' atom counts of pour20k (POUR20K_ATOMS), regenerated
    by the port on the CPU in f64, and its f32 run's last ke against its
    f64 run's (POUR20K_KE_F32) (~10 min)."""
    from tpumd_torch.bench_targets import IN_POUR20K, POUR20K_ATOMS, \
        POUR20K_KE_F32, POUR20K_STEPS
    ke = {}
    for dtype in (torch.float64, torch.float32):
        t = TScript(device="cpu", dtype=dtype)
        t.run_string(IN_POUR20K)
        t.sim.verbose = False
        t.run_string(f"run {POUR20K_STEPS}")
        rows = {int(p[0]): int(p[1]) for p in
                (ln.split() for ln in t.sim.log_lines)
                if p and p[0].isdigit()}
        assert rows == POUR20K_ATOMS
        ke[dtype] = t.sim.last_thermo["ke"]
    assert ke[torch.float32] == pytest.approx(ke[torch.float64],
                                              rel=POUR20K_KE_F32)
