"""The eight pair-style goldens run verbatim through the port against the
reference binary's own logs.

pair_born, pair_ljexpand, pair_couldebye (thermo.csv), pair_table
(log.test) and wolfdsf's in.borndsf, in.bornwolf, in.ljdsf and in.ljwolf
(born/coul/dsf, born/coul/wolf, lj/cut/coul/dsf, lj/cut/coul/wolf, with
their Coulomb self-energy) run unedited through tpumd_torch's LammpsScript
on the CPU in float64, and every printed thermo row equals the
reference's as printed (``tpumd_torch.pair_goldens``; the card's check in
chip_smoke.py allows one unit of the last printed digit).
"""

import os

import pytest
import torch

from tpumd_torch import pair_goldens as pg

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("name", sorted(pg.DECKS))
def test_pair_golden(name):
    script = pg.run(GOLD, name, "cpu", torch.float64)
    assert not script.sim._ctx.is_cellgrid
    assert pg.failures(GOLD, name, script) == []
    assert pg.equal_as_printed(GOLD, name, script)


def test_failures_see_a_wrong_digit():
    """A row one unit off in the last printed digit passes, two fail."""
    script = pg.run(GOLD, "pair_born", "cpu", torch.float64)
    lines = script.sim.log_lines
    i = next(k for k, ln in enumerate(lines) if ln.split()[:1] == ["20"])
    row = lines[i]
    for new, ok in (("8.3690243", True), ("8.3690244", False)):
        lines[i] = row.replace("8.3690242", new)
        assert (pg.failures(GOLD, "pair_born", script) == []) == ok
