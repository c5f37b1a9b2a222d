"""The 21 reference decks of tpumd's pair-style tests through the port.

tests/test_pair_misc_golden.py (morse, buck, yukawa, soft),
test_pair_breadth2.py (seven neutral styles; eight charged ones, four
under PPPM) and test_hybrid.py (hybrid/overlay, hybrid/scaled): each deck
runs 10 steps through the port on the CPU in float64 and its last row
meets the reference binary's numbers at those tests' tolerances (temp,
epair, etotal 1e-6, press 1e-5; ``tpumd_torch.pair_goldens.REFERENCE``,
the texts and numbers copied there), and every printed row equals tpumd's
run of the same deck on its matrix engine to 1e-10 relative.
"""

import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import pair_goldens as pg
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)


def rows(sim):
    return [[float(v) for v in ln.split()] for ln in sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]


@pytest.mark.parametrize("name", sorted(pg.REFERENCE))
def test_reference_deck(name):
    deck = pg.REFERENCE[name][0]
    pre, run = deck.rsplit("\nrun", 1)
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(deck)
    assert not ts.sim._ctx.is_cellgrid
    assert pg.reference_failures(name, ts.sim.last_thermo) == []
    js = JScript()
    js.run_string(pre)
    js.sim.neighbor_mode = "matrix"
    js.run_string("run" + run)
    got, want = rows(ts.sim), rows(js.sim)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-10, abs=1e-12)
