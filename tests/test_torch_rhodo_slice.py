"""The rhodo_class slice end to end: the port against tpumd and the
reference binary.

* The rhodo_class deck (``bench_targets.IN_RHODO_CLASS``: CHARMM 8/10 with
  arithmetic mixing, harmonic bonds, CHARMM angles and dihedrals,
  harmonic impropers, PPPM 1e-4, SHAKE of the hydrogen bonds and water
  angles, z-coupled NPT, special_bonds charmm) on the 2,004-atom peptide
  (``replicate`` left out) through tpumd (float64, cell grid forced)
  and through tpumd_torch on the CPU in float64: the grid, the per-tag
  special lists, the step-0 forces per tag (1e-10 of max|f|), every
  energy component at step 0 (1e-10), and the printed thermo rows, box and
  rebuild counts over 20 steps are equal.
* The peptide NVT deck of tests/test_peptide_golden.py on the port: its
  step-0 row against the reference binary's log (log.ref) at that test's
  tolerances.
* The 32,064-atom rhodo_class deck's step-0 row against the reference
  binary's (tools/bench_all.py:80-81), f64 on the CPU (slow).
"""

import os

import numpy as np
import pytest
import torch

from test_peptide_golden import DECK as NVT_DECK
from test_peptide_golden import KEYS as NVT_KEYS
from test_peptide_golden import _multi_rows
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import IN_RHODO_CLASS, RHODO_STEP0, \
    STEP0_RTOL, gate_failures
from tpumd_torch.ops import charmm_cellgrid
from tpumd_torch.script.parser import LammpsScript as TScript

# the suite runs in several worker processes on shared cores
torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "peptide")
ENERGIES = ("evdwl", "ecoul", "elong", "ebond", "eangle", "edihed", "eimp",
            "temp", "press", "etotal")


def _rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


def _by_tag(s, a):
    tag = np.asarray(s.tag)
    keep = tag > 0
    return np.asarray(a)[keep][np.argsort(tag[keep])]


def _run(script, deck):
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
    if isinstance(script, JScript):
        script._finalize_atoms()
        sim.neighbor_mode = "cellgrid"
    script.run_string("run 0")
    s = sim.state
    row0 = dict(sim.last_thermo)
    f0 = _by_tag(s, s.f)
    special = (_by_tag(s, s.special_tags), _by_tag(s, s.special_codes))
    script.run_string("run 20")
    return sim, row0, f0, special


def test_rhodo_settings_on_the_peptide_match_tpumd():
    deck = IN_RHODO_CLASS.format(golden=GOLDEN).replace(
        "replicate       2 2 4\n", "") + "thermo          5\n"
    jsim, j0, jf0, jsp = _run(JScript(data_dir=GOLDEN), deck)
    n0 = charmm_cellgrid.counts.plain_calls
    tsim, t0, tf0, tsp = _run(TScript(device="cpu", dtype=torch.float64),
                              deck)
    # setup's evaluation, 20 steps, an energy evaluation per thermo row
    assert charmm_cellgrid.counts.plain_calls - n0 >= 1 + 20 + 4
    jc, tc = jsim._neigh_cfg, tsim._neigh_cfg
    assert (tc.nx, tc.ny, tc.nz, tc.cap, tc.cutneigh) == (
        jc.nx, jc.ny, jc.nz, jc.cap, jc.cutneigh) == (2, 2, 2, 368, 12.0)
    for a, b in zip(tsp, jsp):
        np.testing.assert_array_equal(a, b)
    assert tsp[0].shape[1] == 18
    fmax = np.abs(jf0).max()
    np.testing.assert_allclose(tf0, jf0, rtol=0, atol=1e-10 * fmax)
    for k in ENERGIES:
        assert t0[k] == pytest.approx(j0[k], rel=1e-10), k
        assert tsim.last_thermo[k] == pytest.approx(jsim.last_thermo[k],
                                                    rel=1e-8), k
    assert _rows(tsim) == _rows(jsim)
    assert len(_rows(tsim)) == 2 + 2 + 5 + 1
    nb = int(tsim._carry[1].nbuilds)
    assert nb == int(jsim._carry[1].nbuilds) and nb > 1
    # the barostat moved the box along z only
    assert tsim.last_thermo["lz"] == pytest.approx(jsim.last_thermo["lz"],
                                                   rel=1e-12)
    assert tsim.last_thermo["lz"] != t0["lz"]
    assert tsim.last_thermo["lx"] == t0["lx"]


def test_peptide_nvt_step0_matches_log_ref():
    """tests/test_peptide_golden.py:89-96 on the port."""
    ref = _multi_rows(os.path.join(GOLDEN, "log.ref"))
    script = TScript(device="cpu", dtype=torch.float64)
    script.data_dir = GOLDEN
    script.run_string(NVT_DECK.format(steps=0))
    v = script.sim.last_thermo
    sc = abs(ref[0]["TotEng"])
    for rk, k in NVT_KEYS:
        tol = 2e-5 if k in ("elong", "ecoul", "press") else 1e-6
        assert v[k] == pytest.approx(ref[0][rk], rel=tol, abs=sc * tol), rk


@pytest.mark.slow
def test_32k_rhodo_class_step0_gate():
    """The 32,064-atom deck on the port (CPU, f64) against the reference
    binary's step-0 row."""
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(IN_RHODO_CLASS.format(golden=GOLDEN))
    script.sim.verbose = False
    script.run_string("run 0")
    sim = script.sim
    assert sim.natoms == 32064
    assert not gate_failures(sim.last_thermo, {
        k: (v, STEP0_RTOL) for k, v in RHODO_STEP0.items()})
