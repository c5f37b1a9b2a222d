"""The bonded goldens through the port on the CPU in float64, on the
matrix engine: the 14 decks of tpumd_torch/bonded_goldens.py verbatim
(bonded_extra's three hybrid decks, bonded_misc, bonded_misc2's three,
bonded_table, bond_quartic, class2, bonded2's in.hyb, in.multih and
in.opls, dihedral's in.di), each held to the reference binary's log and
dump at the tolerances of tpumd's own tests of the deck
(``bonded_goldens.failures``), and water_shake (SHAKE and PPPM) forced
onto the matrix engine, held to its log and dump.  The same decks run
through tpumd print the same rows: the decks without a log here, and
water_shake; test_torch_bonded_goldens_tpumd.py does the others.  The
class2 deck's forces come from torch.autograd inside the normal run loop,
which therefore stays outside torch.inference_mode."""

import contextlib
import os
import shutil

import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bonded_goldens as bg

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(__file__), "golden")


KEYS = ("temp", "epair", "emol", "etotal", "press", "ebond", "eangle",
        "edihed", "eimp")


def tpumd_run(text, where):
    """tpumd's simulation after the deck text, run in where."""
    script = JScript(data_dir=where)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        script.run_string(text)
    return script.sim


def same_rows(port: dict, ref: dict, rel=1e-9):
    """Every energy term and thermo key both print agrees to rel."""
    for k in [k for k in KEYS if k in ref]:
        assert port[k] == pytest.approx(float(ref[k]), rel=rel,
                                        abs=1e-10), k


@pytest.mark.parametrize("name", list(bg.DECKS))
def test_bonded_golden_against_reference(name, tmp_path):
    script = bg.run(GOLD, name, str(tmp_path), "cpu", torch.float64)
    assert script.sim._ctx.is_cellgrid == (name in bg.ON_GRID)
    assert bg.failures(GOLD, name, script, str(tmp_path)) == []


@pytest.mark.parametrize("name", ["hyb", "multih", "opls", "di"])
def test_bonded_golden_against_tpumd(name, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "tpumd").mkdir()
    port = bg.run(GOLD, name, str(tmp_path / "port"), "cpu", torch.float64)
    path = bg.stage(GOLD, name, str(tmp_path / "tpumd"))
    with open(path) as fh:
        ref = tpumd_run(fh.read(), str(tmp_path / "tpumd"))
    same_rows(port.sim.last_thermo, ref.last_thermo)


def test_water_shake_on_the_matrix_engine(tmp_path):
    script = bg.run_water_shake_matrix(GOLD, str(tmp_path), "cpu",
                                       torch.float64)
    assert script.sim._mode == "matrix"
    assert script.sim.shake_fixes()
    assert bg.water_shake_failures(GOLD, script, str(tmp_path)) == []


def test_water_shake_matrix_equals_tpumd(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "tpumd").mkdir()
    port = bg.run_water_shake_matrix(GOLD, str(tmp_path / "port"), "cpu",
                                     torch.float64)
    d = os.path.join(GOLD, "water_shake")
    shutil.copy(os.path.join(d, "data.water"), tmp_path / "tpumd")
    with open(os.path.join(d, "in.test")) as fh:
        ref = tpumd_run(fh.read(), str(tmp_path / "tpumd"))
    same_rows(port.sim.last_thermo, ref.last_thermo, rel=1e-7)
