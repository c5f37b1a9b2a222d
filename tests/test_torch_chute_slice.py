"""The chute slice end to end: the port against tpumd.

A small generated chute pack (``bench_targets.chute_data`` 10x6x8: 480
spheres, a 9x5x4 grid of cap 8, z non-periodic and shrink-wrapped) runs
``IN_CHUTE`` (gran/hooke/history with shear history, fix gravity chute,
freeze and nve/sphere on groups, the base-base exclusion, compute
erotate/sphere, thermo_modify norm no) through tpumd (float64, cell grid
forced) and through tpumd_torch on the CPU in float64 for 40 steps.  The
printed thermo rows (step atoms ke c_1 vol) are equal, and so are the
grid, the rebuild count, the slot order and the contact-history tables
(tags equal, shear to 1e-12 of its largest).

Slow: the 32,000-sphere deck's step-0 row on the port against the gates
of bench_targets, and the gates regenerated by tpumd (~5 min, ~10 GB).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import CHUTE_STEP0, CHUTE_STEP100, IN_CHUTE, \
    STEP0_RTOL, chute_data, gate_failures
from tpumd_torch.ops import gran_cellgrid as b6
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("ke", "c_1", "vol", "atoms")


def _deck(tmp_path, dims=(10, 6, 8), thermo=10):
    path = tmp_path / "data.chute"
    chute_data(path, *dims)
    return IN_CHUTE.format(data=path).replace(
        "thermo          100", f"thermo          {thermo}")


def _run(script, deck, nsteps):
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
    if isinstance(script, JScript):
        sim.neighbor_mode = "cellgrid"
    script.run_string(f"run {nsteps}")
    return sim


def _thermo_rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


def test_chute_slice_matches_tpumd(tmp_path):
    deck = _deck(tmp_path)
    jsim = _run(JScript(), deck, 40)
    n0 = b6.counts.plain_calls
    tsim = _run(TScript(device="cpu", dtype=torch.float64), deck, 40)
    # set-up, 40 in-step sweeps and one per thermo row after it
    assert b6.counts.plain_calls - n0 == 1 + 40 + 4
    # tpumd keeps the exclusion on its grid config, the port on the style
    assert dataclasses.asdict(jsim._neigh_cfg) == {
        **dataclasses.asdict(tsim._neigh_cfg),
        "exclude_bits": tsim.pair.exclude_bits}
    cfg = tsim._neigh_cfg
    assert (cfg.nx, cfg.ny, cfg.nz, cfg.cap) == (9, 5, 4, 8)
    rows = _thermo_rows(tsim)
    assert rows == _thermo_rows(jsim)
    assert len(rows) == 7 and rows[0].split() == [
        "Step", "atoms", "KinEng", "c_1", "Volume"]
    for k in KEYS:
        assert tsim.last_thermo[k] == pytest.approx(jsim.last_thermo[k],
                                                    rel=1e-10), k
    # the box's upper z face followed the atoms at the rebuilds
    assert tsim.last_thermo["vol"] != float(rows[1].split()[-1])
    js, jn = jsim._carry[0], jsim._carry[1]
    ts, tn, _ = tsim._carry
    nbuilds = int(tn.nbuilds)
    assert nbuilds == int(jn.nbuilds) and nbuilds > 1
    np.testing.assert_array_equal(ts.tag.numpy(), np.asarray(js.tag))
    np.testing.assert_array_equal(tn.shear_tags.numpy(),
                                  np.asarray(jn.shear_tags))
    jsh = np.asarray(jn.shear)
    np.testing.assert_allclose(tn.shear.numpy(), jsh, rtol=0,
                               atol=1e-12 * np.abs(jsh).max())
    live = (tn.shear_tags != 0).sum(1)
    assert 0 < int(live.max()) <= 8
    np.testing.assert_allclose(ts.omega.numpy(), np.asarray(js.omega),
                               rtol=0, atol=1e-10)


def test_cli_runs_the_chute_deck(tmp_path):
    """python -m tpumd_torch reads the sphere data file relative to the
    deck."""
    chute_data(tmp_path / "data.chute", 6, 6, 4)
    deck = tmp_path / "in.chute"
    deck.write_text(IN_CHUTE.format(data="data.chute").replace(
        "thermo          100", "thermo          5") + "run 10\n")
    log = tmp_path / "log"
    out = subprocess.run(
        [sys.executable, "-m", "tpumd_torch", "-in", str(deck), "--device",
         "cpu", "--dtype", "f64", "-log", str(log)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [ln for ln in log.read_text().splitlines()
            if not ln.startswith(("Loop time", "Performance"))]
    assert len(rows) == 5     # header, steps 0, 5, 10, rebuild count
    assert rows[1].split()[:2] == ["0", "144"]


def _chute_32k(script, tmp_path, nsteps):
    chute_data(tmp_path / "data.chute")
    sim = _run(script, IN_CHUTE.format(data=tmp_path / "data.chute"), 0)
    row0 = dict(sim.last_thermo)
    if nsteps:
        script.run_string(f"run {nsteps}")
    return sim, row0, dict(sim.last_thermo)


@pytest.mark.slow
def test_chute_targets_from_tpumd(tmp_path):
    """The 32k chute targets of bench_targets, regenerated by tpumd on the
    CPU in float64 with the cell grid forced."""
    sim, row0, row100 = _chute_32k(JScript(), tmp_path, 100)
    print("CHUTE_STEP0", {k: row0[k] for k in KEYS})
    print("CHUTE_STEP100", {k: row100[k] for k in KEYS})
    for k, v in CHUTE_STEP0.items():
        assert row0[k] == pytest.approx(v, rel=1e-12), k
    for k, (v, _) in CHUTE_STEP100.items():
        assert row100[k] == pytest.approx(v, rel=1e-9), k


@pytest.mark.slow
def test_32k_chute_step0_gate(tmp_path):
    """The 32,000-sphere chute deck's step-0 row on the port (CPU, f64)
    against the gates."""
    sim, row0, _ = _chute_32k(TScript(device="cpu", dtype=torch.float64),
                              tmp_path, 0)
    assert sim.natoms == 32000
    assert not gate_failures(row0, {k: (v, STEP0_RTOL)
                                    for k, v in CHUTE_STEP0.items()})
