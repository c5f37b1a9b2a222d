"""PPPM of the port against tpumd's, in float64 on the CPU.

On LAMMPS's solvated peptide example (tests/golden/peptide/data.peptide,
2,004 charges in a 27.4 A box, PPPM 1e-4 with the Coulomb cutoff 10 A),
the port's ``PPPM`` (point-scatter assignment by ``index_add_``,
``torch.fft``, stencil gather) against tpumd's ``PPPM.compute`` (whose
assignment is a separable matmul on meshes this large):

* the parameter model: the mesh and g_ewald are equal (the reference's
  15 15 15 and 0.268725 of log.ref), and so are the Green's function and
  the virial coefficients (1e-13);
* forces to 1e-10 of max|f|, the energy and the virial to 1e-10, on the
  data file's box;
* with ``dynamic_box`` on (a barostat), after the box is stretched along
  z by 3 % with the positions scaled: both engines recompute the
  box-dependent coefficients from the new box, and agree to the same
  tolerances; the static coefficients would not.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.core.state import make_state as j_make_state
from tpumd.models.kspace_pppm import PPPM as JPPPM
from tpumd.utils.units import get_units as j_units
from tpumd_torch.core.state import Box
from tpumd_torch.interop import pppm_from_numpy
from tpumd_torch.io.read_data import read_data
from tpumd_torch.models.kspace_pppm import PPPM
from tpumd_torch.utils.units import get_units

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "peptide", "data.peptide")
CUT_COUL = 10.0


@pytest.fixture(scope="module")
def peptide():
    return read_data(DATA, "full")


def _j_pppm(d, x, lo, hi, dynamic):
    box = JBox.orthogonal(lo, hi, dtype=jnp.float64)
    s = j_make_state(x, d.v, d.types, box, q=d.q, dtype=jnp.float64)
    fix = SimpleNamespace(pstat=dynamic)
    sim = SimpleNamespace(units=j_units("real"), state=s, natoms=d.natoms,
                          pair=SimpleNamespace(cut_coul=CUT_COUL,
                                               g_ewald=0.0),
                          fixes=[fix])
    ks = JPPPM(1e-4)
    ks.init(sim)
    return ks, s


def _t_pppm(d, lo, hi, dynamic):
    ks = PPPM(1e-4)
    ks.init(d.natoms, d.q, np.asarray(hi) - np.asarray(lo),
            get_units("real"), CUT_COUL, dynamic_box=dynamic)
    return ks


def _compare(jks, js, tks, x, lo, hi, q):
    fj, ej, vj = jks.compute(js, True, True)
    fj, vj = np.asarray(fj), np.asarray(vj)
    box = Box.orthogonal(lo, hi, device="cpu", dtype=torch.float64)
    f, e, v = tks.compute(torch.as_tensor(x), torch.as_tensor(q), box, True,
                          True)
    fmax = np.abs(fj).max()
    assert fmax > 1.0
    np.testing.assert_allclose(f.numpy(), fj, rtol=0, atol=1e-10 * fmax)
    assert float(e) == pytest.approx(float(ej), rel=1e-10)
    np.testing.assert_allclose(v.numpy(), vj, rtol=0,
                               atol=1e-10 * np.abs(vj).max())
    return f, e, v


def test_pppm_matches_tpumd(peptide):
    d = peptide
    jks, js = _j_pppm(d, d.x, d.box_lo, d.box_hi, False)
    tks = _t_pppm(d, d.box_lo, d.box_hi, False)
    assert (tks.nx, tks.ny, tks.nz) == (jks.nx, jks.ny, jks.nz) \
        == (15, 15, 15)
    assert tks.g_ewald == jks.g_ewald
    # log.ref prints it to 6 digits
    assert tks.g_ewald == pytest.approx(0.268725, abs=5e-7)
    np.testing.assert_allclose(tks.greensfn, jks.greensfn, rtol=1e-13,
                               atol=0)
    np.testing.assert_allclose(tks.vg, jks.vg, rtol=1e-13, atol=1e-15)
    # nothing is computed from the box per call without a barostat
    assert not tks.dynamic_box
    _, e, _ = _compare(jks, js, tks, d.x, d.box_lo, d.box_hi, d.q)
    assert float(e) < 0.0
    # tpumd's mesh and g_ewald carried over give the same solver
    carried = pppm_from_numpy(d.natoms, d.q, d.box_hi - d.box_lo, CUT_COUL,
                              1e-4, (jks.nx, jks.ny, jks.nz), jks.g_ewald,
                              "real")
    np.testing.assert_array_equal(carried.greensfn, tks.greensfn)


def test_pppm_dynamic_box_matches_tpumd(peptide):
    d = peptide
    lo, hi = np.array(d.box_lo), np.array(d.box_hi)
    jks, _ = _j_pppm(d, d.x, lo, hi, True)
    tks = _t_pppm(d, lo, hi, True)
    assert jks.dynamic_box and tks.dynamic_box
    # the barostat stretches z about the box centre by 3 %
    c = 0.5 * (lo[2] + hi[2])
    lo2, hi2 = lo.copy(), hi.copy()
    lo2[2], hi2[2] = c + 1.03 * (lo[2] - c), c + 1.03 * (hi[2] - c)
    x2 = d.x.copy()
    x2[:, 2] = lo2[2] + (d.x[:, 2] - lo[2]) / (hi[2] - lo[2]) \
        * (hi2[2] - lo2[2])
    js2 = j_make_state(x2, d.v, d.types,
                       JBox.orthogonal(lo2, hi2, dtype=jnp.float64),
                       q=d.q, dtype=jnp.float64)
    f, e, v = _compare(jks, js2, tks, x2, lo2, hi2, d.q)
    # the static coefficients of the old box would give other forces
    static = _t_pppm(d, lo, hi, False)
    fs, _, _ = static.compute(
        torch.as_tensor(x2), torch.as_tensor(d.q),
        Box.orthogonal(lo2, hi2, device="cpu", dtype=torch.float64), True,
        True)
    assert float((fs - f).abs().max()) > 1e-6 * float(f.abs().max())
