"""Single-type lj/cut beside per-tuple bonded styles on the cell grid: B1's
special-weighted variant (ops/lj_cellgrid.py, its plain list sweep on the
CPU) against tpumd and the stencil oracle, in f64.

* The hyb32k cell replicated 2x2x2 (2,048 atoms, a 41 A box, 4 cells a
  side at cutneigh 10 A; lj/cut 8.0 with special_bonds lj/coul 0 0 0.5 and
  eight hybrid bonded sub-styles) on the forced grid in both packages,
  the list checked every step (ROADMAP C2): the step-0 pair forces (the
  weighed sweep alone) by tag to 1e-12 of max|f|, rows at steps 0, 2 and
  4 to 1e-10.  (The total forces differ by up to 2.7e-11 of max|f| on
  either engine: the two packages' harmonic impropers near 180 deg round
  apart, as the matrix engines do.)
* lj_pairlist_plain with weights (0, 0, 0.5) and (0, 1, 1) over that
  grid's list against the stencil oracle (lj_cellgrid_plain matching the
  special tags), totals and per-slot tallies: a code of weight 1 counts
  fully, one of weight 0 not at all.
* pair_modify shift yes: the weighed energy takes the offset with the
  weight, as factor_lj does; the grid equals the matrix engine.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.ops import lj_cellgrid as b1
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
KEYS = ("temp", "epair", "ebond", "eangle", "edihed", "eimp", "etotal",
        "press")


def hyb(tmp_path, extra=""):
    data = tmp_path / "data.hyb"
    if not data.exists():
        bt.hyb_cell(str(data))
    return (bt.IN_HYB32K.format(data=data, n=2, thermo=2)
            + "neigh_modify    every 1 delay 0 check yes\n" + extra)


def run(script, deck, mode, steps=None):
    """script after the deck on the engine mode, run 0 then steps; the
    pair forces of step 0 by tag."""
    with contextlib.redirect_stdout(io.StringIO()):
        script.run_string(deck)
        script.sim.neighbor_mode = mode
        script.run_string("run 0")
        s, neigh = script.sim._carry[:2]
        if isinstance(script, JScript):
            from tpumd.md.verlet import compute_forces_cats
            fp = compute_forces_cats(s, neigh, script.sim._ctx, ("pair",),
                                     script.sim._consts)
        else:
            from tpumd_torch.md.verlet import compute_forces
            fp = compute_forces(s, neigh, script.sim._ctx, False, False,
                                cats=("pair",))[0]
        f0 = by_tag(fp, s.tag)
        if steps:
            script.run_string(f"run {steps}")
    return f0


def by_tag(f, tag):
    f, tag = np.asarray(f), np.asarray(tag)
    live = tag > 0
    return f[live][np.argsort(tag[live])]


def test_hyb_grid_equals_tpumd(tmp_path):
    deck = hyb(tmp_path)
    b1.counts.reset()
    port = TScript(device="cpu", dtype=torch.float64)
    f_port = run(port, deck, "cellgrid", 4)
    assert port.sim._ctx.is_cellgrid and port.sim.state.special_tags \
        is not None
    assert b1.counts.plain_calls >= 5 and b1.counts.kernel_launches == 0
    ref = JScript()
    f_ref = run(ref, deck, "cellgrid", 4)
    assert ref.sim._ctx.is_cellgrid
    assert np.abs(f_port - f_ref).max() <= 1e-12 * np.abs(f_ref).max()
    rows = {int(r["step"]): r for r in port.sim.thermo_rows}
    jrows = {int(r["step"]): r for r in ref.sim.thermo_rows}
    assert sorted(rows) == sorted(jrows) == [0, 2, 4]
    for step in rows:
        for k in KEYS:
            assert rows[step][k] == pytest.approx(
                float(jrows[step][k]), rel=1e-10, abs=1e-10), (step, k)


@pytest.mark.parametrize("weights", [(0.0, 0.0, 0.5), (0.0, 1.0, 1.0)])
def test_plain_list_against_stencil_oracle(weights, tmp_path):
    port = TScript(device="cpu", dtype=torch.float64)
    run(port, hyb(tmp_path), "cellgrid")
    sim = port.sim
    s, neigh, _ = sim._carry
    cfg, c = sim._neigh_cfg, sim.pair.kernel_coeffs()
    codes = torch.unique(s.special_codes[s.special_tags > 0])
    assert codes.tolist() == [1, 2, 3]
    oracle = (s.tag, s.special_tags, s.special_codes, weights)
    for eflag, vflag in ((1, 1), ("atom", "atom")):
        got = b1.lj_pairlist_plain(s.x, s.box, c, eflag, vflag, neigh.pairs,
                                   neigh.npairs, special=weights)
        if eflag == "atom":
            assert got[1].sum() == pytest.approx(float(want[1]), rel=1e-12)
            assert torch.allclose(got[2].sum(0), want[2], rtol=1e-12,
                                  atol=1e-9)
            continue
        want = b1.lj_cellgrid_plain(s.x, neigh.valid, s.box, cfg, c, 1, 1,
                                    special=oracle)
        scale = float(want[0].abs().max())
        assert float((got[0] - want[0]).abs().max()) <= 1e-12 * scale
        assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-12)
        assert torch.allclose(got[2], want[2], rtol=1e-12, atol=1e-9)
    # the weights move the result: codes 2 and 3 count fully at (0, 1, 1)
    plain = b1.lj_pairlist_plain(s.x, s.box, c, 1, 0, neigh.pairs,
                                 neigh.npairs)
    assert float(got[1].sum()) != pytest.approx(float(plain[1]), rel=1e-6)


def test_shifted_energy_grid_equals_matrix(tmp_path):
    deck = hyb(tmp_path, "pair_modify     shift yes\n")
    rows = {}
    for mode in ("cellgrid", "matrix"):
        script = TScript(device="cpu", dtype=torch.float64)
        run(script, deck, mode)
        assert script.sim.pair.offset[1, 1] != 0
        rows[mode] = dict(script.sim.last_thermo)
    for k in KEYS:
        assert rows["cellgrid"][k] == pytest.approx(
            rows["matrix"][k], rel=1e-11, abs=1e-10), k
