"""The NEMD fixes of the port (md/fix_nemd.py) on the CPU in float64.

* tests/golden/nemd's four decks verbatim (thermal/conductivity,
  viscosity, heat, nve/limit + oneway) against the reference binary's
  logs at tests/test_nemd.py's tolerance (rel 1e-7), f_2 included; the
  port's run of in.tc and in.visc also equals tpumd's printed rows.
* A swap reads nothing back to the host: every tensor read (item, tolist,
  cpu, numpy, bool, int, float) is counted while the fixes act.
* The tie rule: equal candidates go to the atom first in the reference's
  row order; viscosity's metric is taken in float64 also in a float32 run.
* fix vector's table and fix heat's negative-energy error.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from tpumd_torch import remainder_goldens as rg
from tpumd_torch.md.fix_nemd import FixHeat, FixThermalConductivity, \
    FixViscosity
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NEMD = ("nemd_tc", "nemd_visc", "nemd_heat", "nemd_misc")


@pytest.mark.parametrize("name", NEMD)
def test_nemd_golden_against_reference(name, tmp_path):
    script = rg.run(GOLD, name, str(tmp_path), "cpu", torch.float64)
    assert script.sim.step == 100
    assert rg.failures(GOLD, name, script, str(tmp_path)) == []


@pytest.mark.parametrize("name", ("nemd_tc", "nemd_visc"))
def test_nemd_rows_equal_tpumd(name, tmp_path):
    """Every printed row, f_2 included, equals tpumd's."""
    from tpumd.script.parser import LammpsScript as JScript
    d, deck = rg.DECKS[name][:2]
    with open(os.path.join(GOLD, d, deck)) as fh:
        text = fh.read()
    j = JScript(data_dir=str(tmp_path))
    with contextlib.redirect_stdout(sys.stderr):
        j.run_string(text)
    t = rg.run(GOLD, name, str(tmp_path), "cpu", torch.float64)

    def table(lines):
        return [ln.split() for ln in lines if ln.split()
                and ln.split()[0].isdigit()]
    assert table(t.sim.log_lines) == table(j.sim.log_lines)


class _Reads:
    """Counts every read of a tensor's value into Python or numpy."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def __enter__(self):
        self.count = 0
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def wrap(*a, _fn=fn, **k):
                self.count += 1
                return _fn(*a, **k)
            setattr(torch.Tensor, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)


def _deck_state(name, tmp_path, dtype=torch.float64):
    """(script, fix, its state) of a golden deck after run 0."""
    d, deck = rg.DECKS[name][:2]
    with open(os.path.join(GOLD, d, deck)) as fh:
        text = fh.read().rsplit("\nrun", 1)[0] + "\nrun 0\n"
    t = TScript(device="cpu", dtype=dtype)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(text)
    sim = t.sim
    k = next(i for i, fx in enumerate(sim._ctx.fixes)
             if fx.name in ("thermal/conductivity", "viscosity", "heat",
                            "oneway"))
    return t, sim._ctx.fixes[k], sim._carry[2][k]


@pytest.mark.parametrize("name", NEMD)
def test_swap_reads_nothing_back(name, tmp_path):
    t, fx, fs = _deck_state(name, tmp_path)
    sim = t.sim
    s = sim._carry[0]
    fs = fx.set_step(fs, fx.nevery)
    with _Reads() as reads:
        s2, fs2 = fx.end_of_step(s, fs, sim._ctx)
        if hasattr(fx, "device_output") and fx.device_output(fs2) is not None:
            fx.device_output(fs2).add_(0.0)
    assert reads.count == 0
    assert not torch.equal(s2.v, s.v)


def test_thermal_swap_equals_host_pick(tmp_path):
    """The swap moves the hottest atom of slab 0 and the coldest of slab
    Nbin/2, exchanging velocities in their centre-of-mass frame; f_2 grows
    by the kinetic energy moved."""
    t, fx, fs = _deck_state("nemd_tc", tmp_path)
    s = t.sim._carry[0]
    v = s.v.numpy().copy()
    ke = 0.5 * (v * v).sum(1)
    z = s.x[:, 2].numpy()
    lo, hi = s.box.lo[2].item(), s.box.hi[2].item()
    slab = np.floor((z - lo) / ((hi - lo) / 20)).astype(int)
    i = np.nonzero(slab == 0)[0][np.argmax(ke[slab == 0])]
    j = np.nonzero(slab == 10)[0][np.argmin(ke[slab == 10])]
    s2, fs2 = fx.end_of_step(s, fx.set_step(fs, 10), t.sim._ctx)
    vcm = 0.5 * (v[i] + v[j])
    np.testing.assert_allclose(s2.v[i].numpy(), 2 * vcm - v[i], rtol=1e-15)
    np.testing.assert_allclose(s2.v[j].numpy(), 2 * vcm - v[j], rtol=1e-15)
    moved = np.dot(vcm, vcm - v[j]) - np.dot(vcm, vcm - v[i])
    assert float(fs2[1]) == pytest.approx(moved, rel=1e-14)
    keep = np.ones(len(v), bool)
    keep[[i, j]] = False
    np.testing.assert_array_equal(s2.v.numpy()[keep], v[keep])


def test_tie_goes_to_first_in_reference_order():
    key = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    sel = torch.tensor([True, True, True, True, False])
    rank = torch.tensor([0, 4, 1, 2, 3])
    (row, found), = FixThermalConductivity._picks(key, sel, rank, 1)
    assert int(row) == 2 and bool(found)
    picks = FixThermalConductivity._picks(key, sel, rank, 5)
    assert [int(r) for r, _ in picks[:4]] == [2, 1, 3, 0]
    assert [bool(f) for _, f in picks] == [True] * 4 + [False]


def test_viscosity_metric_in_f64(tmp_path):
    """In a float32 run the distance to vtarget = 1e10 is taken in
    float64, so the picks are the extreme velocities (in float32 every
    |v - 1e10| rounds to 1e10 and all would tie)."""
    t, fx, fs = _deck_state("nemd_visc", tmp_path, torch.float32)
    s = t.sim._carry[0]
    vx = s.v[:, 0].double().numpy()
    z = s.x[:, 2].double().numpy()
    lo, hi = float(s.box.lo[2]), float(s.box.hi[2])
    slab = np.floor((z - lo) / ((hi - lo) / 20)).astype(int)
    pos = np.nonzero((slab == 0) & (vx >= 0))[0]
    neg = np.nonzero((slab == 10) & (vx <= 0))[0]
    want = sorted([pos[np.argmax(vx[pos])], neg[np.argmin(vx[neg])]])
    s2, _ = fx.end_of_step(s, fx.set_step(fs, 10), t.sim._ctx)
    moved = torch.nonzero(s2.v[:, 0] != s.v[:, 0]).flatten().tolist()
    assert sorted(moved) == want


def test_fix_vector_table(tmp_path):
    t = TScript(device="cpu", dtype=torch.float64)
    with open(os.path.join(GOLD, "nemd", "in.tc")) as fh:
        text = fh.read().replace("run             100", "")
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(text + "fix v all vector 10 temp f_2\nrun 40\n")
    fx = next(f for f in t.sim.fixes if f.name == "vector")
    table = fx.output(t.sim)
    assert table.shape == (4, 2)
    assert table[-1, 1] == pytest.approx(t.sim.last_thermo["f_2"],
                                         rel=1e-12)
    assert table[-1, 0] == pytest.approx(t.sim.last_thermo["temp"],
                                         rel=1e-12)


def test_heat_negative_raises(tmp_path):
    t = TScript(device="cpu", dtype=torch.float64)
    with open(os.path.join(GOLD, "nemd", "in.heat")) as fh:
        text = fh.read().replace("heat 5 2.0", "heat 5 -5000.0")
    with pytest.raises(RuntimeError, match="kinetic energy went negative"):
        with contextlib.redirect_stdout(sys.stderr):
            t.run_string(text)
    assert isinstance(next(f for f in t.sim.fixes if f.name == "heat"),
                      FixHeat)
    assert FixViscosity("10", "x", "z", "20").vtarget == 1.0e10
