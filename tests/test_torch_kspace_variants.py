"""The PPPM variants, kspace_modify and fix tune/kspace in the port against
tpumd on the CPU in float64, on the matrix engine.

* tests/golden/pppm_stagger (lj/charmm/coul/long with pppm/stagger): every
  printed row equal to tpumd's to 1e-10 relative and the step-0 forces to
  1e-12 of max|f|; the port's run meets log.test and dump.stagger at
  tests/test_pppm_stagger.py's tolerances (the stagger qopt grid, 12^3).
* The same water under pppm with kspace_modify diff ad, and under pppm/cg:
  every row equal to tpumd's; the solver's tables (the ad Green's function
  and self-force coefficients) equal, and carried over by
  ``interop.with_kspace_state`` they give the same forces.
* Each kspace_modify key (eight, in four decks) gives tpumd's g_ewald,
  mesh and order (and for the disp keys g_ewald_6 and the dispersion mesh)
  and its step-0 energies; gewald under ewald raises (ROADMAP C21).
* fix tune/kspace, its clock replaced by one that charges each step the
  solver's cost, swaps and keeps what tpumd does, both ways.
"""

import contextlib
import os
import time

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import kspace_goldens as kg
from tpumd_torch.interop import with_kspace_state
from tpumd_torch.script.parser import LammpsScript as TScript
from torch_kspace_parity import assert_rows_equal, both

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def run_both(name, tmp_path_factory):
    where = str(tmp_path_factory.mktemp(name.replace("/", "_")))
    kg.stage(GOLD, "pppm_stagger", where)
    return where, both(kg.deck_text(GOLD, name), data_dir=where)


@pytest.fixture(scope="module")
def stagger(tmp_path_factory):
    return run_both("pppm_stagger", tmp_path_factory)


def check_parity(result):
    js, ts, jrows, trows, jf0, tf0 = result
    assert not ts.sim._ctx.is_cellgrid
    assert_rows_equal(trows, jrows)
    fmax = np.abs(jf0).max()
    assert fmax > 1.0
    assert np.abs(tf0 - jf0).max() <= 1e-12 * fmax
    jk, tk = js.sim.kspace, ts.sim.kspace
    assert (tk.nx, tk.ny, tk.nz) == (jk.nx, jk.ny, jk.nz)
    assert tk.g_ewald == pytest.approx(jk.g_ewald, rel=1e-13)
    np.testing.assert_allclose(tk.greensfn, jk.greensfn, rtol=1e-12,
                               atol=1e-14 * np.abs(jk.greensfn).max())


def test_stagger_golden_port_equals_tpumd(stagger):
    check_parity(stagger[1])
    assert stagger[1][1].sim.kspace.style == "pppm/stagger"


def test_stagger_golden_against_reference(tmp_path):
    script = kg.run(GOLD, "pppm_stagger", str(tmp_path), "cpu",
                    torch.float64)
    assert kg.failures(GOLD, "pppm_stagger", script, str(tmp_path)) == []


@pytest.mark.parametrize("name", sorted(kg.VARIANTS))
def test_water_variant_port_equals_tpumd(name, tmp_path_factory):
    _, result = run_both(name, tmp_path_factory)
    check_parity(result)
    js, ts = result[:2]
    jk, tk = js.sim.kspace, ts.sim.kspace
    assert tk.style == ("pppm/cg" if name == "pppm_cg" else "pppm")
    if name == "pppm_ad":
        assert tk.mode == "ad"
        np.testing.assert_allclose(tk.sf_coeff, jk.sf_coeff, rtol=1e-12)
    # tpumd's solver tables carried over: the same forces on one state
    s = ts.sim.state
    f_own = tk.compute(s.x, s.q, s.box, False, False, type_=s.type)[0]
    state = {"nx": jk.nx, "ny": jk.ny, "nz": jk.nz, "g_ewald": jk.g_ewald,
             "greensfn": np.asarray(jk.greensfn), "vg": np.asarray(jk.vg)}
    if name == "pppm_ad":
        state["sf_coeff"] = list(jk.sf_coeff)
    with_kspace_state(tk, state)
    f_carried = tk.compute(s.x, s.q, s.box, False, False, type_=s.type)[0]
    assert torch.allclose(f_carried, f_own, rtol=0,
                          atol=1e-12 * float(f_own.abs().max()))


BASE = """units real
atom_style full
bond_style harmonic
angle_style harmonic
pair_style {pair}
kspace_style {kspace}
{modify}
special_bonds lj/coul 0.0 0.0 0.5
read_data data.water
bond_coeff 1 450.0 0.9572
angle_coeff 1 55.0 104.52
pair_coeff 1 1 0.1521 3.1507
pair_coeff 2 2 0.0 1.0
neighbor 2.0 bin
neigh_modify every 1 delay 0 check yes
"""
COUL = "lj/cut/coul/long 6.0 7.0"
DISP = "lj/long/coul/long long long 7.0"
# each key of tpumd's kspace_modify, in four decks
MODIFY = {
    "diff,order": (COUL, "pppm 1e-4", "kspace_modify diff ad order 7"),
    "mesh,gewald": (COUL, "pppm 1e-4",
                    "kspace_modify mesh 16 18 20 gewald 0.31"),
    "disp/auto,mesh/disp,order/disp": (
        DISP, "pppm/disp 1e-4",
        "kspace_modify disp/auto yes mesh/disp 10 10 12 order/disp 4"),
    "gewald/disp": (DISP, "pppm/disp 1e-4",
                    "kspace_modify gewald/disp 0.29 mesh/disp 8 8 8"),
}


def set_up(script, deck):
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        script.run_string(deck)
        script.sim.neighbor_mode = "matrix"
        script.run_string("run 0")
    return script.sim


@pytest.mark.parametrize("key", sorted(MODIFY))
def test_kspace_modify_equals_tpumd(key):
    pair, kspace, modify = MODIFY[key]
    deck = BASE.format(pair=pair, kspace=kspace, modify=modify)
    where = os.path.join(GOLD, "pppm_disp")
    jsim = set_up(JScript(data_dir=where), deck)
    script = TScript(device="cpu", dtype=torch.float64)
    script.data_dir = where
    tsim = set_up(script, deck)
    jk, tk = jsim.kspace, tsim.kspace
    assert (tk.nx, tk.ny, tk.nz, tk.order) == (jk.nx, jk.ny, jk.nz, jk.order)
    assert tk.g_ewald == pytest.approx(jk.g_ewald, rel=1e-13)
    if "disp" in key:
        assert tuple(tk.n6) == tuple(jk.n6) and tk.order_6 == jk.order_6
        assert tk.g_ewald_6 == pytest.approx(jk.g_ewald_6, rel=1e-13)
    for k in ("epair", "elong", "press"):
        assert tsim.last_thermo[k] == pytest.approx(
            float(jsim.last_thermo[k]), rel=1e-10), k
    if key == "mesh,gewald":
        assert (tk.nx, tk.ny, tk.nz) == (16, 18, 20) and tk.g_ewald == 0.31
    if key.startswith("diff"):
        assert tk.mode == "ad" and tk.order == 7


@pytest.mark.parametrize("style", ["ewald", "ewald/disp"])
def test_gewald_under_ewald_raises(style):
    script = TScript(device="cpu", dtype=torch.float64)
    script.data_dir = os.path.join(GOLD, "pppm_disp")
    deck = BASE.format(pair=DISP, kspace=f"{style} 1e-4", modify="")
    script.run_string(deck)
    with pytest.raises(NotImplementedError, match="C21"):
        script.run_string("kspace_modify gewald 0.3")


def test_kspace_modify_refusals():
    script = TScript(device="cpu", dtype=torch.float64)
    script.data_dir = os.path.join(GOLD, "pppm_disp")
    script.run_string(BASE.format(pair=COUL, kspace="pppm 1e-4", modify=""))
    for line in ("kspace_modify mesh/disp 8 8 8", "kspace_modify slab 3.0",
                 "kspace_modify mesh 8 8"):
        with pytest.raises(NotImplementedError):
            script.run_string(line)


SALT = """units lj
atom_style charge
read_data {gold}/wolfdsf/data.salt
pair_style born/coul/long 3.2
pair_coeff * * 1.5 0.4 1.2 1.0 0.5
kspace_style {start} 1e-5
velocity all create 1.0 87287 loop geom
neighbor 0.3 bin
neigh_modify delay 0 every 1
fix 1 all nve
fix 2 all tune/kspace 5
timestep 0.004
thermo 5
"""


@pytest.mark.parametrize("start,costs,keep", [
    ("pppm", {"pppm": 2.0, "ewald": 1.0}, "ewald"),
    ("ewald", {"pppm": 1.0, "ewald": 3.0}, "pppm")],
    ids=["pppm-to-ewald", "ewald-to-pppm"])
def test_tune_kspace_installs_what_tpumd_installs(start, costs, keep,
                                                  monkeypatch):
    """The clock reads step x the running solver's cost, so each window
    of 5 steps measures 5 x its cost."""
    kept = []
    for script in (JScript(), TScript(device="cpu", dtype=torch.float64)):
        def clock(sim=None):
            sim = script.sim
            name = getattr(sim.kspace, "style", type(sim.kspace).__name__)
            return sim.step * costs["pppm" if name.lower().startswith(
                "pppm") else "ewald"]
        monkeypatch.setattr(time, "perf_counter", clock)
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            script.run_string(SALT.format(gold=GOLD, start=start))
            script.sim.neighbor_mode = "matrix"
            script.run_string("run 20")
        monkeypatch.undo()
        name = getattr(script.sim.kspace, "style",
                       type(script.sim.kspace).__name__).lower()
        kept.append("pppm" if name.startswith("pppm") else "ewald")
        assert any("keeping " + keep in ln for ln in script.sim.log_lines)
    assert kept == [keep, keep]
