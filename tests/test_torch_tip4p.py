"""TIP4P in the port (lj/cut/tip4p/long with pppm/tip4p,
tpumd_torch/models/pair_tip4p.py) against tpumd on the CPU in float64, on
the matrix engine, and against the reference binary.

* tests/golden/tip4p: every printed row equal to tpumd's to 1e-10
  relative, the step-0 forces to 1e-12 of max|f|, alpha and the charge
  sites (by tag) equal to tpumd's; the port's run meets log.ref at
  tests/test_tip4p.py's tolerances.
* The sites follow the tags, not the rows: with every per-atom row of the
  set-up state permuted and the neighbour list rebuilt, the sites and the
  forces by tag are the same to 1e-12.
* Refusals: pppm without /tip4p beside a TIP4P style, pppm/tip4p beside
  another style, the cell grid, and a box narrower than 2 cutneigh (the
  19 A box under a 4 A skin: cutneigh 11.3).
"""

import os

import numpy as np
import pytest
import torch

from tpumd_torch import kspace_goldens as kg
from tpumd_torch.core.state import map_per_atom
from tpumd_torch.interop import tip4p_from_numpy
from tpumd_torch.md.verlet import build_matrix, compute_forces
from tpumd_torch.script.parser import LammpsScript as TScript
from torch_kspace_parity import assert_rows_equal, both, by_tag

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    where = str(tmp_path_factory.mktemp("tip4p"))
    kg.stage(GOLD, "tip4p", where)
    return both(kg.deck_text(GOLD, "tip4p"), data_dir=where)


def test_tip4p_golden_port_equals_tpumd(golden):
    js, ts, jrows, trows, jf0, tf0 = golden
    assert not ts.sim._ctx.is_cellgrid
    assert ts.sim.kspace.style == "pppm/tip4p"
    assert_rows_equal(trows, jrows)
    fmax = np.abs(jf0).max()
    assert fmax > 1.0
    assert np.abs(tf0 - jf0).max() <= 1e-12 * fmax
    jk, tk = js.sim.kspace, ts.sim.kspace
    assert (tk.nx, tk.ny, tk.nz) == (jk.nx, jk.ny, jk.nz)
    assert tk.g_ewald == pytest.approx(jk.g_ewald, rel=1e-14)


def test_tip4p_sites_equal_tpumd(golden):
    js, ts = golden[:2]
    jp, tp = js.sim.pair, ts.sim.pair
    a_ref = 0.15 / (np.cos(np.radians(104.52) / 2) * 0.9572)
    assert tp.alpha == pytest.approx(a_ref, rel=1e-12)
    assert tp.alpha == pytest.approx(jp.alpha, rel=1e-15)
    jx = js.sim.state
    jxq = by_tag(jp.charge_sites(jx.x, jx.box), jx.tag)
    s = ts.sim.state
    txq = by_tag(tp.charge_sites(s, ts.sim.natoms).xq, s.tag)
    assert np.abs(txq - jxq).max() <= 1e-12
    # tpumd's alpha and waters carried over give the same sites
    jtag = np.asarray(jx.tag)
    h1, h2 = np.asarray(jp._h1), np.asarray(jp._h2)
    o = np.flatnonzero(np.asarray(jp._is_o))
    waters = np.stack([jtag[o], jtag[h1[o]], jtag[h2[o]]], axis=1)
    carried = tip4p_from_numpy(tp, jp.alpha, waters, device="cpu")
    cxq = by_tag(carried.charge_sites(s, ts.sim.natoms).xq, s.tag)
    assert np.abs(cxq - jxq).max() <= 1e-12


def test_tip4p_golden_against_reference(tmp_path):
    script = kg.run(GOLD, "tip4p", str(tmp_path), "cpu", torch.float64)
    assert kg.failures(GOLD, "tip4p", script, str(tmp_path)) == []


def test_tip4p_rows_permuted():
    """The sites and forces by tag do not change when every row is
    permuted (the O and its H resolved from the tags at each
    evaluation)."""
    where = os.path.join(GOLD, "tip4p")
    script = TScript(device="cpu", dtype=torch.float64)
    script.data_dir = where
    text = kg.deck_text(GOLD, "tip4p").rsplit("\nrun", 1)[0]
    script.run_string(text + "\nrun 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    ctx = sim._ctx
    f, e, v, _, _ = compute_forces(s, neigh, ctx, True, True)
    perm = torch.randperm(s.x.shape[0], generator=torch.Generator()
                          .manual_seed(7))
    s2 = map_per_atom(s, lambda t: t[perm])
    assert not torch.equal(s2.tag, s.tag)
    neigh2 = build_matrix(s2, ctx, 1)
    f2, e2, v2, _, _ = compute_forces(s2, neigh2, ctx, True, True)
    xq = by_tag(sim.pair.charge_sites(s, sim.natoms).xq, s.tag)
    xq2 = by_tag(sim.pair.charge_sites(s2, sim.natoms).xq, s2.tag)
    assert np.abs(xq2 - xq).max() <= 1e-12
    fa, fb = by_tag(f, s.tag), by_tag(f2, s2.tag)
    assert np.abs(fb - fa).max() <= 1e-12 * np.abs(fa).max()
    for k in ("evdwl", "ecoul", "elong"):
        assert float(e2[k]) == pytest.approx(float(e[k]), rel=1e-12)
    assert np.abs((v2 - v).numpy()).max() <= 1e-12 * np.abs(v.numpy()).max()


@pytest.mark.parametrize("edit,match", [
    (("kspace_style    pppm/tip4p 1e-4", "kspace_style pppm 1e-4"),
     "pppm/tip4p"),
    (("pair_style      lj/cut/tip4p/long 1 2 1 1 0.15 6.0 7.0",
      "pair_style lj/cut/coul/long 6.0 7.0"), "TIP4P"),
    (None, "lj/cut/tip4p/long"),
    (("neighbor        2.0 bin", "neighbor 4.0 bin"), "lj/cut/tip4p/long")],
    ids=["pppm", "pair", "cellgrid", "small"])
def test_tip4p_refusals(edit, match, tmp_path):
    text = kg.deck_text(GOLD, "tip4p").rsplit("\nrun", 1)[0]
    if edit is not None:
        text = text.replace(*edit)
    kg.stage(GOLD, "tip4p", str(tmp_path))
    script = TScript(device="cpu", dtype=torch.float64)
    script.data_dir = str(tmp_path)
    script.run_string(text)
    if edit is None:
        script.sim.neighbor_mode = "cellgrid"
    with pytest.raises((NotImplementedError, ValueError), match=match):
        script.run_string("run 0")


@pytest.mark.slow
def test_tip4p30k_step0_targets(golden):
    """IN_TIP4P30K's step-0 row through the port on the CPU in f64 (~10 s,
    ~1 GB): the card's targets (bench_targets.TIP4P30K_STEP0_F64) to
    1e-12; evdwl and emol 80x tpumd's cell's (tests/golden/tip4p at step
    0) to 1e-10; ecoul + elong 80x the cell's within
    TIP4P30K_COUL_RTOL of the cell's 80 ecoul (the 30k box's PPPM mesh and
    g_ewald differ from the cell's)."""
    from tpumd_torch import bench_targets as bt
    jrows = golden[2]
    cell = {k: float(v) for k, v in jrows[0].items()}
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(bt.IN_TIP4P30K.format(
        golden=os.path.join(GOLD, "tip4p"), thermo=100))
    script.sim.verbose = False
    script.run_string("run 0")
    row = script.sim.last_thermo
    for k, want in bt.TIP4P30K_STEP0_F64.items():
        assert row[k] == pytest.approx(want, rel=1e-12, abs=1e-12), k
    n = bt.TIP4P30K_REPLICAS
    assert row["evdwl"] == pytest.approx(n * cell["evdwl"], rel=1e-10)
    assert row["emol"] == pytest.approx(n * cell["emol"], abs=1e-9)
    coul = row["ecoul"] + row["elong"]
    want = n * (cell["ecoul"] + cell["elong"])
    assert abs(coul - want) <= bt.TIP4P30K_COUL_RTOL * n * abs(cell["ecoul"])
