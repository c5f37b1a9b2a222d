"""The LJ-melt slice end to end: the port against tpumd.

Each deck runs through tpumd (float64, cell grid forced as in
tests/test_cellgrid.py, which the CPU would not pick by itself) and
through tpumd_torch on the CPU in float64.  The step-0 forces agree per
atom matched by tag (rtol 1e-10, atol 1e-12: summation order only, on
lattice forces that cancel to ~1e-13), thermo agrees to 1e-10 relative at
step 0 and after the run, and the printed thermo rows and rebuild counts
are equal.  The runs cross rebuilds on the every/delay schedule, every
step (a 2x2x2 grid), on the displacement check, and through a cell
overflow that grows the cap and redoes the segment.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import IN_LJ, SANITY, STEP0, STEP0_RTOL, \
    gate_failures
from tpumd_torch.script.parser import LammpsScript as TScript

# the suite runs in several worker processes on shared cores: keep the
# plain torch sweeps from oversubscribing them
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = {
    # the 6^3 deck of tests/test_cellgrid.py: 40 steps cross two rebuilds
    "6cube_every20": (IN_LJ.format(n=6), 40, None),
    # 2x2x2 cells at cap 32, the lattice's exact occupancy: the first
    # rebuild overflows, the cap grows and the segment is redone
    "4cube_regrow": (IN_LJ.format(n=4).replace(
        "every 20", "every 10"), 20, 32),
    # 2x2x2 cells, shifted potential, a rebuild every step
    "4cube_shift_every1": (IN_LJ.format(n=4).replace(
        "delay 0 every 20 check no", "delay 0 every 1 check no")
        + "pair_modify     shift yes\n", 20, None),
    # rebuilds decided by the half-skin displacement check
    "5cube_check": (IN_LJ.format(n=5).replace(
        "delay 0 every 20 check no", "delay 0 every 1 check yes"), 40, None),
}
KEYS = ("temp", "epair", "etotal", "press")


def _run(script, deck, nsteps, cap):
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
    sim._cap_override = cap
    if isinstance(script, JScript):
        sim.neighbor_mode = "cellgrid"
    script.run_string("run 0")
    row0 = dict(sim.last_thermo)
    s = sim.state
    tags = np.asarray(s.tag)
    f0 = np.asarray(s.f)[tags > 0][np.argsort(tags[tags > 0])]
    script.run_string(f"run {nsteps}")
    return sim, row0, f0


def _thermo_rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_slice_matches_tpumd(deck):
    text, nsteps, cap = DECKS[deck]
    jsim, j0, jf0 = _run(JScript(), text, nsteps, cap)
    tsim, t0, tf0 = _run(TScript(device="cpu", dtype=torch.float64), text,
                         nsteps, cap)
    assert dataclasses.asdict(jsim._neigh_cfg) == {
        **dataclasses.asdict(tsim._neigh_cfg), "exclude_bits": ()}
    assert cap is None or tsim._neigh_cfg.cap > cap
    np.testing.assert_allclose(tf0, jf0, rtol=1e-10, atol=1e-12)
    for k in KEYS:
        assert t0[k] == pytest.approx(j0[k], rel=1e-10), k
        assert tsim.last_thermo[k] == pytest.approx(jsim.last_thermo[k],
                                                    rel=1e-10), k
    assert tsim.step == jsim.step == nsteps
    assert _thermo_rows(tsim) == _thermo_rows(jsim)
    tags = np.sort(tsim.state.tag.numpy())
    assert tags[tags > 0].tolist() == list(range(1, tsim.natoms + 1))


def test_step0_matches_reference_log():
    """tests/test_lj_parity.py:57-67: the in.lj step-0 row."""
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(IN_LJ.format(n=6) + "run 0\n")
    v = script.sim.last_thermo
    assert v["temp"] == pytest.approx(1.44, rel=1e-12)
    assert v["epair"] == pytest.approx(-6.7733681, rel=1e-6)


def test_import_leaves_out_jax():
    """No module of tpumd_torch, nor chip_smoke.py, imports jax, flax or
    tpumd; the rhodo_class path's modules among them."""
    rhodo = ("tpumd_torch.models.pair_charmm",
             "tpumd_torch.models.kspace_pppm", "tpumd_torch.md.fix_shake",
             "tpumd_torch.md.fix_nh", "tpumd_torch.ops.charmm_cellgrid")
    code = (
        "import importlib, pkgutil, sys, tpumd_torch\n"
        "for m in pkgutil.walk_packages(tpumd_torch.__path__, "
        "'tpumd_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"assert all(m in sys.modules for m in {rhodo!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpumd'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('tpumd_torch')]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="cuda"):
            TScript(**kw)


def test_cli_runs_a_deck(tmp_path):
    deck = tmp_path / "in.lj"
    deck.write_text(IN_LJ.format(n=4) + "thermo 5\nrun 10\n")
    log = tmp_path / "log"
    out = subprocess.run(
        [sys.executable, "-m", "tpumd_torch", "-in", str(deck), "--device",
         "cpu", "--dtype", "f64", "-log", str(log)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(deck.read_text())
    rows = _thermo_rows(script.sim)
    assert len(rows) == 5     # header, steps 0, 5, 10, rebuild count
    assert [ln for ln in log.read_text().splitlines()
            if not ln.startswith(("Loop time", "Performance"))] == rows
    if not torch.cuda.is_available():
        # --device defaults to cuda, which this machine does not have
        out = subprocess.run(
            [sys.executable, "-m", "tpumd_torch", "-in", str(deck)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and "cuda" in out.stderr


@pytest.mark.slow
def test_32k_deck_bench_gates():
    """The 32,000-atom in.lj deck on the port (CPU, f64) against the
    step-0 and step-100 gates of tools/bench_all.py:70-72,85-86."""
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(IN_LJ.format(n=20))
    script.sim.verbose = False
    script.run_string("run 0")
    assert not gate_failures(script.sim.last_thermo, {
        k: (v, STEP0_RTOL) for k, v in STEP0["lj"].items()})
    script.run_string("run 100")
    assert not gate_failures(script.sim.last_thermo, SANITY["lj"])
