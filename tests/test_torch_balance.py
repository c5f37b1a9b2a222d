"""The balance command and fix balance (tpumd_torch/parallel/balance.py,
md/fix_ave.py::FixBalance) against tpumd's, on the CPU in f64.

* rcb_order, dim_sort_order and slab_imbalance give tpumd's permutations
  and figures on the same seeded clouds.
* tests/test_balance.py's deck through both packages with 8 parts (tpumd
  takes its 8 virtual CPU devices, the port the part count the test
  gives it): the same printed line, the same tag order and positions row
  for row after the command, and the same step-0 row.
* fix balance 10 1.0 rcb on the 4^3 melt on the forced matrix engine:
  tpumd's thermo rows and first log line; on the grid a no-op; beside fix
  spring/self (its anchors ride MDState.peratom) the rows of the melt
  without fix balance.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tpumd.parallel import balance as jb
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.parallel import balance as tb
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

DECK = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 8 0 8 0 8
create_box      1 box
region          half block 0 8 0 8 0 4
create_atoms    1 region half
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
fix             1 all nve
"""

MELT = """
units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.44 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
fix 1 all nve
fix 2 all balance 10 1.0 rcb
thermo 10
"""

KEYS = ("temp", "epair", "etotal", "press")


@pytest.fixture
def eight_parts(monkeypatch):
    """The port's default part count at 8, tpumd's CPU device count."""
    monkeypatch.setattr(tb, "part_count", lambda device: 8)


def cloud(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 1, (3000, 3)),
                           rng.uniform(-8, 8, (500, 3))])


@pytest.mark.parametrize("nparts", [2, 3, 8])
@pytest.mark.parametrize("seed", [7, 11])
def test_orders_equal_tpumd(seed, nparts):
    x = cloud(seed)
    order = tb.rcb_order(x, nparts)
    assert np.array_equal(order, jb.rcb_order(x, nparts))
    assert sorted(order) == list(range(len(x)))
    for dims in ("x", "zy", "xyz"):
        assert np.array_equal(tb.dim_sort_order(x, dims),
                              jb.dim_sort_order(x, dims))
    for o in (np.arange(len(x)), order):
        assert tb.slab_imbalance(x, o, nparts) == jb.slab_imbalance(
            x, o, nparts)
    sizes = np.diff([len(x) * k // nparts for k in range(nparts + 1)])
    assert tb.imbalance(sizes.astype(float)) == jb.imbalance(
        sizes.astype(float))


def printed(script, line):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        script.run_string(line)
    return [ln for ln in out.getvalue().splitlines() if "rebalancing" in ln]


@pytest.mark.parametrize("style", ["1.1 rcb", "1.1 shift zx 10 1.1", "1.1 y"])
def test_balance_command_equals_tpumd(style, eight_parts, tmp_path):
    jscript = JScript(data_dir=str(tmp_path))
    tscript = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(io.StringIO()):
        jscript.run_string(DECK)
        tscript.run_string(DECK)
    line = printed(jscript, f"balance {style}")
    assert len(line) == 1 and line == printed(tscript, f"balance {style}")
    js, ts = jscript.sim.state, tscript.sim.state
    tag = np.asarray(js.tag)
    assert np.array_equal(tag, ts.tag.numpy())
    np.testing.assert_array_equal(np.asarray(js.x), ts.x.numpy())
    assert not np.array_equal(tag, np.sort(tag))
    with contextlib.redirect_stdout(io.StringIO()):
        jscript.run_string("run 0")
        tscript.run_string("run 0")
    for k in KEYS:
        assert tscript.sim.last_thermo[k] == pytest.approx(
            float(jscript.sim.last_thermo[k]), rel=1e-12, abs=1e-12), k


def test_balance_one_part_keeps_rows():
    """On one card (the CPU's default) the permutation is the identity."""
    script = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(io.StringIO()):
        script.run_string(DECK)
    script._finalize_atoms()
    x0 = script.sim.state.x.clone()
    before, after = tb.balance_atoms(script.sim, "rcb")
    assert torch.equal(script.sim.state.x, x0) and before == after


def melt_rows(script, mode):
    with contextlib.redirect_stdout(io.StringIO()):
        script.run_string(MELT)
        script._finalize_atoms()
        script.sim.neighbor_mode = mode
        script.sim.invalidate_ctx()
        script.sim.run(20)
    return {int(r["step"]): r for r in script.sim.thermo_rows}


def test_fix_balance_equals_tpumd(eight_parts):
    jscript = JScript()
    tscript = TScript(device="cpu", dtype=torch.float64)
    jrows = melt_rows(jscript, "matrix")
    trows = melt_rows(tscript, "matrix")
    assert sorted(trows) == sorted(jrows) == [0, 10, 20]
    for step in trows:
        for k in KEYS:
            assert trows[step][k] == pytest.approx(
                float(jrows[step][k]), rel=1e-10, abs=1e-12), (step, k)
    jlog = [ln for ln in jscript.sim.log_lines if "fix balance" in ln]
    tlog = [ln for ln in tscript.sim.log_lines if "fix balance" in ln]
    assert len(tlog) == len(jlog) == 2 and tlog[0] == jlog[0]


def test_fix_balance_on_the_grid_is_a_noop(eight_parts):
    script = TScript(device="cpu", dtype=torch.float64)
    rows = melt_rows(script, "cellgrid")
    assert script.sim._ctx.is_cellgrid
    assert not [ln for ln in script.sim.log_lines if "fix balance" in ln]
    plain = TScript(device="cpu", dtype=torch.float64)
    ref = melt_rows(plain, "cellgrid")
    assert rows == ref


def test_fix_balance_moves_per_atom_fix_state(eight_parts):
    """fix spring/self keeps its anchors by row in MDState.peratom: fix
    balance's reorder and the re-set-up's sort move them with their
    atoms, so the tethered melt's rows equal the same melt's without fix
    balance.  (tpumd's anchors stay by row through its re-set-up's sort,
    ROADMAP C41.)"""
    deck = MELT.replace("fix 2 all balance", "fix 3 all spring/self 5.0\n"
                        "fix 2 all balance")
    rows = {}
    for name, text in (("balanced", deck),
                       ("plain", deck.replace("fix 2 all balance 10 1.0 "
                                              "rcb\n", ""))):
        script = TScript(device="cpu", dtype=torch.float64)
        with contextlib.redirect_stdout(io.StringIO()):
            script.run_string(text)
            script._finalize_atoms()
            script.sim.neighbor_mode = "matrix"
            script.sim.invalidate_ctx()
            script.sim.run(20)
        rows[name] = {int(r["step"]): r for r in script.sim.thermo_rows}
        fired = [ln for ln in script.sim.log_lines if "fix balance" in ln]
        assert len(fired) == (2 if name == "balanced" else 0)
    assert sorted(rows["balanced"]) == [0, 10, 20]
    for step in (0, 10, 20):
        for k in KEYS:
            assert rows["balanced"][step][k] == pytest.approx(
                rows["plain"][step][k], rel=1e-10, abs=1e-12), (step, k)
