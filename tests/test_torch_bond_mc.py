"""fix bond/break and fix bond/create in the port (md/fix_bond_mc.py) on
the CPU in float64.

* tests/golden/bond_break and bond_create verbatim against the reference
  binary's logs and force dumps at tests/test_bond_break.py's and
  test_bond_create.py's tolerances (rel 1e-6 to 1e-7; forces 1e-9 of the
  largest), with the reference's bonds and special entries left.
* A 6x6x6 monomer gas under bond/create, run through tpumd and the port:
  the bonds made at each event are the same tag pairs, and the rows agree.
* Candidates come from the neighbor rows: an Rmin past the pair cutoff
  raises; a redone segment puts the event's rows back; prob, type
  changes and a forced cell grid raise; dump local's rows are the bonds.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from tpumd_torch import remainder_goldens as rg
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

GAS = """
units           lj
atom_style      bond
lattice         fcc 0.8442
region          box block 0 6 0 6 0 6
create_box      1 box bond/types 1 extra/bond/per/atom 2 extra/special/per/atom 4
create_atoms    1 box
mass            1 1.0
special_bonds   lj/coul 0.0 0.0 0.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0
bond_style      harmonic
bond_coeff      1 50.0 1.0
neighbor        0.3 bin
neigh_modify    every 1 delay 0 check yes
velocity        all create 1.5 2763 loop geom
fix             1 all nve
fix             2 all bond/create 5 1 1 1.15 1 iparam 1 1 jparam 1 1
timestep        0.005
thermo          5
thermo_style    custom step temp ebond epair etotal press
"""


@pytest.mark.parametrize("name", ("bond_break", "bond_create"))
def test_bond_golden_against_reference(name, tmp_path):
    script = rg.run(GOLD, name, str(tmp_path), "cpu", torch.float64)
    assert script.sim._mode == "matrix"
    assert rg.failures(GOLD, name, script, str(tmp_path)) == []


def _pairs(bonds):
    return {tuple(sorted(int(t) for t in b[1:])) for b in bonds}


def test_create_gas_equals_tpumd(tmp_path):
    """The same bonds at the same events, and the same rows, as tpumd's
    dense candidate search."""
    from tpumd.script.parser import LammpsScript as JScript
    import jax
    j = JScript(data_dir=str(tmp_path))
    t = TScript(device="cpu", dtype=torch.float64)
    made_j, made_t = [], []
    for step in range(4):
        with contextlib.redirect_stdout(sys.stderr):
            j.run_string((GAS if step == 0 else "") + "run 5\n")
            t.run_string((GAS if step == 0 else "") + "run 5\n")
        s = j.sim.state
        live = np.asarray(jax.device_get(s.extras["mc_new_live"])) > 0.5
        pidx = np.asarray(jax.device_get(s.extras["mc_new_pidx"])).astype(
            int)
        tag = np.asarray(jax.device_get(s.tag))
        rr, cc = np.nonzero(live)
        made_j.append({tuple(sorted((int(tag[r]), int(tag[pidx[r, c]]))))
                       for r, c in zip(rr, cc)})
        made_t.append(_pairs(t.sim.live_topology("bond")))
    assert made_t == made_j
    assert len(made_t[-1]) > len(made_t[0]) > 0
    for k in ("temp", "ebond", "epair", "etotal", "press"):
        assert t.sim.last_thermo[k] == pytest.approx(
            j.sim.last_thermo[k], rel=1e-8, abs=1e-12), k


def test_create_caps_and_lengths(tmp_path):
    """At every event no atom passes its cap and every new bond is shorter
    than Rmin when it forms; the count never falls."""
    t = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(GAS + "run 0\n")
    counts = [0]
    for _ in range(4):
        live = t.sim.live_topology("bond")
        before = _pairs([] if live is None else live)
        with contextlib.redirect_stdout(sys.stderr):
            t.run_string("run 5\n")
        bonds = t.sim.live_topology("bond")
        new = _pairs(bonds) - before
        s = t.sim._carry[0]
        x = torch.zeros((t.sim.natoms + 1, 3), dtype=torch.float64)
        x[s.tag.long()] = s.x
        ell = (s.box.hi - s.box.lo).numpy()
        for a, b in new:
            d = (x[a] - x[b]).numpy()
            d -= ell * np.round(d / ell)
            assert np.linalg.norm(d) < 1.15 + 1e-12
        deg = np.bincount(np.asarray(bonds)[:, 1:].ravel())
        assert deg.max() <= 1
        counts.append(len(bonds))
    assert counts == sorted(counts) and counts[-1] > 0


def test_rmin_past_cutoff_raises():
    t = TScript(device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="neighbor rows"):
        with contextlib.redirect_stdout(sys.stderr):
            t.run_string(GAS.replace("1 1 1.15 1", "1 1 2.9 1") + "run 0\n")


@pytest.mark.parametrize("line,match", [
    ("fix 3 all bond/create 5 1 1 1.15 1 prob 0.5 8811", "prob"),
    ("fix 3 all bond/create 5 1 1 1.15 1 iparam 1 2", "type change"),
    ("fix 3 all bond/break 5 1 1.5 prob 0.5 8811", "prob"),
])
def test_refusals(line, match):
    t = TScript(device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=match):
        with contextlib.redirect_stdout(sys.stderr):
            t.run_string(GAS + line + "\n")


def test_forced_grid_raises():
    t = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(GAS)
    t.sim.neighbor_mode = "cellgrid"
    with pytest.raises(NotImplementedError, match="matrix engine"):
        with contextlib.redirect_stdout(sys.stderr):
            t.run_string("run 0\n")


def test_redone_event_restores_rows(tmp_path):
    """A segment replayed from its snapshot puts the event's rows back
    first, so the replay makes the same bonds once."""
    t = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(GAS + "run 0\n")
    sim = t.sim
    snap = sim._carry
    fx = next(f for f in sim.fixes if f.name == "bond/create")
    sim._advance(snap, sim._ctx, 5, [None] * len(sim._ctx.fixes))
    first = (int(fx._count), fx._table.clone())
    carry, _ = sim._advance(snap, sim._ctx, 5, [None] * len(sim._ctx.fixes))
    assert int(fx._count) == first[0] > 0
    assert torch.equal(fx._table, first[1])


def test_dump_local_rows_are_the_bonds(tmp_path):
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(GAS + "compute bl all bond/local dist engpot force\n"
                     "compute pl all property/local batom1 batom2 btype\n"
                     "dump d all local 10 bonds.local c_pl[1] c_pl[2] "
                     "c_bl[1]\nrun 20\n")
    with open(tmp_path / "bonds.local") as fh:
        lines = fh.read().splitlines()
    frames, i = {}, 0
    while i < len(lines):
        k = int(lines[i + 3])
        frames[int(lines[i + 1])] = np.array(
            [[float(v) for v in ln.split()] for ln in lines[i + 9:i + 9 + k]])
        i += 9 + k
    rows = frames[20]
    assert len(rows) == len(t.sim.live_topology("bond")) > 0
    assert _pairs(np.c_[np.ones(len(rows)), rows[:, :2]]) == _pairs(
        t.sim.live_topology("bond"))
    assert (rows[:, 2] < 1.6).all()


def test_chains_get_their_1_3_entries():
    """With two bonds an atom, the segment end after an event rebuilds the
    special lists from the live bonds: the running state holds their 1-3
    entries (ROADMAP C34)."""
    from tpumd_torch.io.read_data import build_special
    t = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(GAS.replace("iparam 1 1 jparam 1 1",
                                 "iparam 2 1 jparam 2 1")
                     .replace("extra/special/per/atom 4",
                              "extra/special/per/atom 8") + "run 40\n")
    bonds = t.sim.live_topology("bond")
    assert np.bincount(bonds[:, 1:].ravel()).max() == 2
    st, sc = build_special(t.sim.natoms, bonds)
    s = t.sim._carry[0]
    got = {(int(a), int(b), int(c)) for a, row, crow in zip(
        s.tag, s.special_tags, s.special_codes)
        for b, c in zip(row, crow) if b > 0}
    want = {(i + 1, int(b), int(c)) for i in range(len(st))
            for b, c in zip(st[i], sc[i]) if b > 0}
    assert got == want and any(c == 2 for _, _, c in got)
