"""The bonded goldens that have a log in the repository, through the port
(CPU, float64, matrix engine) and through tpumd: the same last thermo
row, every energy term printed, to 1e-9 relative.  (The port's rows
against the reference binary's are tests/test_torch_bonded_goldens.py.)"""

import contextlib
import os

import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bonded_goldens as bg

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("name", [n for n, d in bg.DECKS.items()
                                  if d[3] is not None])
def test_logged_golden_port_equals_tpumd(name, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "tpumd").mkdir()
    port = bg.run(GOLD, name, str(tmp_path / "port"), "cpu", torch.float64)
    path = bg.stage(GOLD, name, str(tmp_path / "tpumd"))
    ref = JScript(data_dir=str(tmp_path / "tpumd"))
    with open(path) as fh, contextlib.redirect_stdout(open(os.devnull,
                                                           "w")):
        ref.run_string(fh.read())
    got, want = port.sim.last_thermo, ref.sim.last_thermo
    keys = [k for k in ("temp", "epair", "emol", "etotal", "press", "ebond",
                        "eangle", "edihed", "eimp") if k in want]
    assert keys
    for k in keys:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-9,
                                       abs=1e-10), k
