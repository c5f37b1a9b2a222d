"""run_style respa in the port (md/verlet.py::respa_step) on the CPU in
float64.

tests/golden/respa_chain reads data.chain, which is not in the repo; its
deck runs instead on ``bench_targets.chain_data`` (2,000 beads, chains of
50), through tpumd and the port:

* ``respa 2 2 bond 1 pair 2`` (FENE twice a pair step): every printed row
  equals tpumd's to 1e-10 relative;
* ``respa 2 1 bond 1 pair 2`` reproduces the verlet run's rows to 1e-10
  over 100 steps;
* the set-up's level forces sum to the force of the whole evaluation; a
  setforce group is zeroed on the inner level too; a fix that integrates
  other than nve raises.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from tpumd_torch.bench_targets import chain_data
from tpumd_torch.md.verlet import RESPA_KEY, compute_forces
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "data.chain")
    chain_data(path, natoms=2000, chain_len=50, seed=2026)
    with open(os.path.join(GOLD, "respa_chain", "in.test")) as fh:
        return fh.read().replace("data.chain", path)


def port(text):
    t = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(text)
    return t


def rows(sim):
    return {int(p[0]): [float(v) for v in p[1:]]
            for p in (ln.split() for ln in sim.log_lines)
            if p and p[0].isdigit()}


def assert_rows(a, b, rtol=1e-10):
    assert sorted(a) == sorted(b)
    for step in a:
        np.testing.assert_allclose(a[step], b[step], rtol=rtol, atol=1e-12,
                                   err_msg=f"step {step}")


def test_respa_equals_tpumd(deck):
    from tpumd.script.parser import LammpsScript as JScript
    j = JScript()
    with contextlib.redirect_stdout(sys.stderr):
        j.run_string(deck)
    t = port(deck)
    assert t.sim._mode == "matrix"
    assert t.sim._ctx.respa == ((2, 1), (("bond",), (
        "angle", "dihedral", "improper", "kspace", "pair")))
    assert_rows(rows(t.sim), rows(j.sim))


def test_respa_2_1_is_verlet(deck):
    text = deck.replace("run             20", "run 100")
    verlet = port(text.replace("run_style       respa 2 2 bond 1 pair 2",
                               ""))
    respa = port(text.replace("respa 2 2", "respa 2 1"))
    assert_rows(rows(respa.sim), rows(verlet.sim))


def test_levels_sum_to_the_force(deck):
    t = port(deck.replace("run             20", "run 0"))
    s, neigh, _ = t.sim._carry
    levels = [s.peratom[RESPA_KEY.format(k)] for k in range(2)]
    whole = compute_forces(s, neigh, t.sim._ctx, False, False)[0]
    torch.testing.assert_close(levels[0] + levels[1], whole, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(s.f, whole, rtol=1e-12, atol=1e-12)
    assert levels[0].abs().max() > 0 and levels[1].abs().max() > 0


def test_setforce_zeroes_every_level(deck):
    text = deck.replace("fix             1 all nve",
                        "fix             1 all nve\ngroup g id 1:40\n"
                        "fix             2 g setforce 0.0 0.0 0.0")
    t = port(text.replace("run             20", "run 10"))
    s = t.sim._carry[0]
    sel = s.tag <= 40
    for k in range(2):
        assert s.peratom[RESPA_KEY.format(k)][sel].abs().max() == 0.0
    assert s.v[sel].abs().max() > 0


def test_integrating_fix_raises(deck):
    with pytest.raises(NotImplementedError, match="respa"):
        port(deck.replace("fix             1 all nve",
                          "fix             1 all nvt temp 1.0 1.0 0.5"))
