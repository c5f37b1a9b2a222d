"""The EAM slice end to end: the port against tpumd.

LAMMPS bench/in.eam (``bench_targets.IN_EAM``: metal units, fcc Cu at
3.615 A, 1600 K, neighbor 1.0 bin, every 1 delay 5 check yes, fix nve,
dt 0.005) on the generated Cu-like potential, at n = 5 (500 atoms, a 3^3
grid) and n = 4 (256 atoms, a 2^3 grid), as a funcfl file (pair_style
eam) and as one-element eam/alloy and eam/fs files.  Each deck runs
through tpumd on its matrix engine (float64, the exact spline tables, an
explicit neighbour list) and through tpumd_torch on the CPU in float64
(the cell grid, the kernels' plain versions).  The step-0 forces agree per
atom matched by tag (rtol 1e-10, atol 1e-12 eV/A: summation order only,
on lattice forces that cancel to ~1e-14), the step-0 row to 1e-10
relative, and the printed thermo rows and rebuild counts over 40 steps
are equal.  The port's force pass sweeps the grid's pair list, gated for
a refresh at the steps before the delay (and after, once gated since the
re-bin); no atom of these decks moves skin/2 within them, so none is
refreshed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import EAM_SANITY, EAM_STEP0, IN_EAM, \
    eam_funcfl, eam_setfl
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import eam_cellgrid
from tpumd_torch.script.parser import LammpsScript as TScript

# the suite runs in several worker processes on shared cores: keep the
# plain torch sweeps from oversubscribing them
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("temp", "epair", "etotal", "press")
# pair_style -> (file writer, pair_coeff arguments after the file)
STYLES = {"eam": (eam_funcfl, ""),
          "eam/alloy": (eam_setfl, " Cu"),
          "eam/fs": (lambda p: eam_setfl(p, fs=True), " Cu")}


def _deck(tmp_path, style, n, thermo=10):
    writer, elems = STYLES[style]
    path = tmp_path / f"Cu.{style.replace('/', '_')}"
    writer(path)
    coeff = "1 1" if style == "eam" else "* *"
    return IN_EAM.format(n=n, potential=path).replace(
        f"pair_coeff      1 1 {path}",
        f"pair_coeff      {coeff} {path}{elems}").replace(
        "pair_style      eam", f"pair_style      {style}").replace(
        "thermo          50", f"thermo          {thermo}")


def _run(script, deck, nsteps):
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
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


@pytest.mark.parametrize("n", [5, 4])
@pytest.mark.parametrize("style", sorted(STYLES))
def test_eam_slice_matches_tpumd(style, n, tmp_path):
    text = _deck(tmp_path, style, n)
    assert f"pair_style      {style}\n" in text
    jsim, j0, jf0 = _run(JScript(), text, 40)
    n0 = eam_cellgrid.rho_counts.plain_calls
    gates = bpl.refresh_counts.plain_calls
    tsim, t0, tf0 = _run(TScript(device="cpu", dtype=torch.float64), text,
                         40)
    assert tsim._ctx.pairlist_refresh and tsim._ctx.pairlist_k > 0
    assert bpl.refresh_counts.plain_calls > gates
    assert tsim.list_refreshes == 0
    assert jsim._resolve_mode() == "matrix"
    cfg = tsim._neigh_cfg
    assert (cfg.nx, cfg.ny, cfg.nz, cfg.delay, cfg.check) == (
        n - 2, n - 2, n - 2, 5, True)
    # one density pass per force evaluation: setup, 40 steps, 4 thermo rows
    assert eam_cellgrid.rho_counts.plain_calls - n0 >= 1 + 40 + 4
    assert tsim.mass[1] == jsim.mass[1] == 63.55
    np.testing.assert_allclose(tf0, jf0, rtol=1e-10, atol=1e-12)
    for k in KEYS:
        assert t0[k] == pytest.approx(j0[k], rel=1e-10), k
        assert tsim.last_thermo[k] == pytest.approx(jsim.last_thermo[k],
                                                    rel=1e-8), k
    assert t0["epair"] / tsim.natoms == pytest.approx(-3.54, rel=1e-6)
    assert tsim.step == jsim.step == 40
    rows = _thermo_rows(tsim)
    assert len(rows) == 10 and rows == _thermo_rows(jsim)
    nbuilds = int(tsim._carry[1].nbuilds)
    assert nbuilds == int(jsim._carry[1].nbuilds) and nbuilds > 2


def test_unported_eam_cases_raise(tmp_path):
    """Two atom types on the cell grid, and bonds, raise at set-up, naming
    the cause ("auto" sends two types to the matrix engine:
    tests/test_torch_eam_matrix.py)."""
    text = _deck(tmp_path, "eam", 4).replace(
        "create_box      1 box", "create_box      2 box").replace(
        "pair_coeff      1 1", "pair_coeff      * *")
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(text)
    script.sim.neighbor_mode = "cellgrid"
    with pytest.raises(NotImplementedError, match="take one element"):
        script.run_string("run 0\n")
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(_deck(tmp_path, "eam", 4))
    script.sim.verbose = False
    script.run_string("run 0")
    s, neigh, _ = script.sim._carry
    with pytest.raises(NotImplementedError, match="bond"):
        script.sim.pair.compute_cellgrid(s.x, neigh.valid, s.box,
                                         script.sim._neigh_cfg, False, False,
                                         bond=(s.tag, s.tag, None, s.tag))


def test_cli_runs_the_eam_deck(tmp_path):
    """python -m tpumd_torch finds the potential file relative to the
    deck, and sets the mass from it."""
    eam_funcfl(tmp_path / "Cu.eam")
    deck = tmp_path / "in.eam"
    deck.write_text(IN_EAM.format(n=4, potential="Cu.eam").replace(
        "thermo          50", "thermo          5") + "run 10\n")
    log = tmp_path / "log"
    out = subprocess.run(
        [sys.executable, "-m", "tpumd_torch", "-in", str(deck), "--device",
         "cpu", "--dtype", "f64", "-log", str(log)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_file(str(deck))
    rows = _thermo_rows(script.sim)
    assert len(rows) == 5     # header, steps 0, 5, 10, rebuild count
    assert rows[1].split()[:3] == ["0", "1600", "-906.24"]
    assert [ln for ln in log.read_text().splitlines()
            if not ln.startswith(("Loop time", "Performance"))] == rows
    # metal time is in ps: ns/day = timesteps/s * 0.005 ps * 86400 / 1000
    perf = [ln for ln in script.sim.log_lines
            if ln.startswith("Performance")][-1].split()
    ns_day, sps = float(perf[1]), float(perf[3])
    assert perf[2] == "ns/day," and ns_day == pytest.approx(
        sps * 0.005 * 86400 / 1000, rel=1e-3, abs=1e-3)


@pytest.mark.slow
def test_eam_targets_from_tpumd(tmp_path):
    """The 32k eam targets of bench_targets, regenerated by tpumd on the
    CPU in float64 on its matrix engine."""
    eam_funcfl(tmp_path / "Cu.eam")
    script = JScript()
    script.run_string(IN_EAM.format(n=20, potential=tmp_path / "Cu.eam"))
    sim = script.sim
    sim.verbose = False
    script.run_string("run 0")
    assert sim._resolve_mode() == "matrix"
    row0 = dict(sim.last_thermo)
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    print("EAM_STEP0", {k: row0[k] for k in EAM_STEP0})
    print("EAM_SANITY", {k: row100[k] for k in EAM_SANITY})
    for k, v in EAM_STEP0.items():
        assert row0[k] == pytest.approx(v, rel=1e-12), k
    for k, (v, _) in EAM_SANITY.items():
        assert row100[k] == pytest.approx(v, rel=1e-9), k
