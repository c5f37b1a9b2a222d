"""The drift protocol of tools/bench_all.py:183-205 (bench_targets.
measure_drift: 500 warm-up steps, then max|E(t) - E0| / |E0| over 1,000
steps sampled every 100) on the 6^3 in.lj deck (864 atoms) and on the
drift deck (shift yes, dt 0.001), through tpumd (float64, the cell grid
forced, as tests/test_cellgrid.py runs it) and the port (CPU, float64):
the two drifts agree to 4 significant digits (relative 5e-5)."""

import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import IN_LJ, IN_LJ_DRIFT, measure_drift
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)


@pytest.mark.parametrize("deck", ["in.lj", "drift"])
def test_drift_matches_tpumd(deck):
    text = (IN_LJ if deck == "in.lj" else IN_LJ_DRIFT).format(n=6)
    drifts = []
    for s in (JScript(), TScript(device="cpu", dtype=torch.float64)):
        s.run_string(text)
        s.sim.verbose = False
        if isinstance(s, JScript):
            s.sim.neighbor_mode = "cellgrid"
        drifts.append(measure_drift(s))
    assert drifts[1] == pytest.approx(drifts[0], rel=5e-5)
    # in.lj's unshifted cutoff drifts by 6.9e-4 here; the drift deck's
    # 1.6e-6 (this 864-atom box; 8.1e-7 at 2,048 atoms)
    assert drifts[1] < (1e-3 if deck == "in.lj" else 2e-6)
