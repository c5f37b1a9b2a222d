"""ewald/disp, pppm/disp and msm with their pair styles (lj/long/coul/long,
lj/cut/coul/msm) in the port against tpumd on the CPU in float64, on the
matrix engine, and against the reference binary.

For each golden (tests/golden/ewald_disp, pppm_disp's in.test and in.mesh,
msm), run once by both packages: every printed row equal to tpumd's to
1e-10 relative, the step-0 forces to 1e-12 of max|f|, the solver's
parameters equal (g_ewald, g_ewald_6, both meshes, MSM's levels, grids and
adjusted cutoff) and its tables (the dispersion Green's function, the MSM
level kernels) equal; tpumd's tables carried into the port by
``interop.with_kspace_state`` give the same forces; and the port's own run
meets the reference binary's log at tpumd's tests' tolerances
(tests/test_ewald_disp.py, test_pppm_disp.py, test_msm.py).
"""

import os

import numpy as np
import pytest
import torch

from tpumd_torch import kspace_goldens as kg
from tpumd_torch.interop import with_kspace_state
from torch_kspace_parity import assert_rows_equal, both

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NAMES = ("ewald_disp", "msm", "pppm_disp", "pppm_disp_mesh")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in NAMES:
        where = str(tmp_path_factory.mktemp(name))
        kg.stage(GOLD, kg.DECKS[name][0], where)
        out[name] = both(kg.deck_text(GOLD, name), data_dir=where)
    return out


def carried_state(name, jk):
    """tpumd's solver tables by the port's attribute names."""
    if name == "msm":
        return {"kernels": [np.asarray(k) for k in jk.kernels],
                "cutoff": jk.cutoff, "levels": jk.levels,
                "ngrids": list(jk.ngrids)}
    if name == "ewald_disp":
        return {"kvecs": jk.kvecs, "ug": jk.ug, "ke6": jk.ke6,
                "kv6_c2": jk.kv6_c2, "g_ewald": jk.g_ewald}
    return {"greensfn": jk.greensfn, "vg": jk.vg, "g_ewald": jk.g_ewald,
            "greensfn_6": jk.greensfn_6, "vg_6": jk.vg_6,
            "g_ewald_6": jk.g_ewald_6, "n6": list(jk.n6),
            "csum": jk.csum, "csumij": jk.csumij,
            "b_type": np.sqrt(np.asarray(jk.cii))}


@pytest.mark.parametrize("name", NAMES)
def test_port_equals_tpumd(name, runs):
    js, ts, jrows, trows, jf0, tf0 = runs[name]
    assert not ts.sim._ctx.is_cellgrid
    assert_rows_equal(trows, jrows)
    fmax = np.abs(jf0).max()
    assert fmax > 1.0
    assert np.abs(tf0 - jf0).max() <= 1e-12 * fmax
    jk, tk = js.sim.kspace, ts.sim.kspace
    if name == "msm":
        assert (tk.levels, tk.ngrids, tk.order) == (jk.levels, jk.ngrids,
                                                   jk.order)
        assert tk.cutoff == pytest.approx(jk.cutoff, rel=1e-14)
        assert ts.sim.pair.cut_coul == tk.cutoff
        for a, b in zip(tk.kernels, jk.kernels):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=1e-13 * np.abs(b).max())
    else:
        assert tk.g_ewald == pytest.approx(jk.g_ewald, rel=1e-13)
        assert tk.g_ewald_6 == pytest.approx(jk.g_ewald_6, rel=1e-13)
        assert ts.sim.pair.g_ewald_6 == tk.g_ewald_6
    if name.startswith("pppm_disp"):
        assert (tk.nx, tk.ny, tk.nz) == (jk.nx, jk.ny, jk.nz)
        assert tuple(tk.n6) == tuple(jk.n6)
        np.testing.assert_allclose(tk.greensfn_6, jk.greensfn_6, rtol=1e-12,
                                   atol=1e-14 * np.abs(jk.greensfn_6).max())
    if name == "ewald_disp":
        assert np.array_equal(tk.kvecs, jk.kvecs)
        np.testing.assert_allclose(tk.ke6, jk.ke6, rtol=1e-13)
    # tpumd's tables carried over: the same forces on one state
    s = ts.sim.state
    f_own, e_own, _ = tk.compute(s.x, s.q, s.box, True, False, type_=s.type)
    with_kspace_state(tk, carried_state(name, jk))
    f, e, _ = tk.compute(s.x, s.q, s.box, True, False, type_=s.type)
    assert torch.allclose(f, f_own, rtol=0,
                          atol=1e-12 * float(f_own.abs().max()))
    assert float(e) == pytest.approx(float(e_own), rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_golden_against_reference(name, tmp_path):
    script = kg.run(GOLD, name, str(tmp_path), "cpu", torch.float64)
    assert kg.failures(GOLD, name, script, str(tmp_path)) == []
