"""The six analysis goldens run verbatim through the port against the
reference binary's own output.

computes, temp_variants, struct_computes, store_histo, chunk_family and
dipole (tests/golden/*) run unedited through tpumd_torch's LammpsScript on
the CPU in float64, their fix ave files and dumps written, and every file
and thermo column the reference wrote is compared
(``tpumd_torch.analysis_goldens.failures``: tpumd's own golden tests'
tolerances).  Where tpumd's test drops a line (test_computes_golden.py
drops `fix 2` and the dump), the port runs it and its file is compared.
The card runs the same decks and comparisons in chip_smoke.py.
"""

import os

import pytest
import torch

from tpumd_torch import analysis_goldens as ag

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("name", sorted(ag.DECKS))
def test_analysis_golden(name, tmp_path):
    script = ag.run(GOLD, name, str(tmp_path), "cpu", torch.float64)
    assert ag.failures(GOLD, name, script) == []


def test_failures_see_a_wrong_file(tmp_path):
    """The comparison fails on output that is off by more than the
    files' digits."""
    script = ag.run(GOLD, "store_histo", str(tmp_path), "cpu",
                    torch.float64)
    path = tmp_path / "dump.ss"
    text = path.read_text().replace(" 0.25 ", " 0.2501 ")
    path.write_text(text)
    assert any("dump.ss" in f for f in ag.failures(GOLD, "store_histo",
                                                   script))
