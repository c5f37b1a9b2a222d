"""The EAM cell-grid kernel module of the port against tpumd.

On the CPU the wrappers ``eam_rho_cellgrid`` and ``eam_force_cellgrid``
run their plain PyTorch versions; these tests hold those against tpumd on
perturbed fcc lattices of the generated Cu-like potential (each atom
moved by up to +-0.15 A per axis), binned into the port's cell grid: a
5^3 lattice (500 atoms, a 3^3 grid) and a 4^3 lattice (256 atoms, a 2^3
grid where every neighbour cell is met at two periodic images).

* f64: per tag, the host density against tpumd's exact spline helper
  ``_spline_val_np`` summed over the minimum-image neighbours, and the
  forces, energy and virial of both passes (through the port's
  ``PairEAM.compute_cellgrid``, its tables carried over from tpumd's by
  ``interop.eam_from_numpy``) against tpumd ``PairEAM.compute``, the
  matrix engine's exact splines, on an all-pairs neighbour list: forces
  1e-12 * max|f|, energy 1e-12 relative, virial 1e-12 * max|virial|,
  density 1e-12 relative (summation order only).
* f32 on the 3^3 grid: the plain passes against the TPU kernels
  ``eam_rho_pallas`` and ``eam_force_pallas`` under
  ``pltpu.force_tpu_interpret_mode()``, pass 2 fed the same F' on both
  sides.  The TPU kernels evaluate Chebyshev fits of the radial splines
  whose error tpumd reports as max_rel_err (relative to max|fn| over the
  fit's [0.22 cut, cut]); every pair of these lattices lies in that range.
  The tolerance is that error summed over each atom's in-cutoff
  neighbours (n_i eps_rho max|rho| for the density;
  n_i (2 max|F'| eps_rho' max|rho'| + eps_z2' max|z2'| / r_min
  + eps_z2 max|z2| / r_min^2) for the force, the bound on |d psip|), plus
  f32 rounding of 1e-5 of the largest value.

The CUDA kernels against the plain versions, on the card, are in
tests/test_torch_cuda_kernels.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpumd.models.pair_eam as jeam
from tpumd.core.state import Box as JBox
from tpumd.ops import cellgrid as jcg
from tpumd.ops.pallas_eam import eam_force_pallas, eam_rho_pallas
from tpumd.ops.segpoly import fit_cheb
from tpumd_torch.bench_targets import EAM_A0, eam_funcfl
from tpumd_torch.core.create import create_atoms_lattice
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.state import Box, make_state, wrap_pbc
from tpumd_torch.interop import eam_from_numpy
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import eam_cellgrid as ec

# the suite runs in several worker processes on shared cores: keep the
# plain torch sweeps from oversubscribing them
torch.set_num_threads(2)

CUTNEIGH, SKIN = 5.95, 1.0     # in.eam: cutoff 4.95 + skin 1.0
GRIDS = {"3cube": 5, "2cube": 4}     # lattice cells per axis


@pytest.fixture(scope="module")
def jpair(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "Cu.eam"
    eam_funcfl(path)
    p = jeam.PairEAM(1)
    p.coeff(1, 1, 1, 1, str(path))
    p.init()
    return p


def _port_pair(jp):
    return eam_from_numpy(jp.frho_spline, jp.rhor_spline, jp.z2r_spline,
                          jp.dr, jp.drho, jp.nr, jp.nrho, jp.rhomax,
                          jp.cutmax)


def _eam_grid(nlat, dtype, seed=11):
    """Grid-ordered state of a perturbed fcc lattice of nlat^3 cells."""
    lat = Lattice("fcc", EAM_A0, units="metal")
    hi = nlat * lat.spacing
    x, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    x = x + np.random.default_rng(seed).uniform(-0.15, 0.15, x.shape)
    box = Box.orthogonal(np.zeros(3), hi, device="cpu", dtype=dtype)
    s = wrap_pbc(make_state(x, np.zeros_like(x), t, box, device="cpu",
                            dtype=dtype))
    cfg = cg.choose_cellgrid_config(box, CUTNEIGH, SKIN, len(x))
    s = cg.pad_state(s, cfg.capacity)
    valid0 = torch.arange(cfg.capacity) < len(x)
    perm, valid, _, over = cg.bin_permutation(s.x, valid0, s.box, cfg)
    assert not bool(over)
    return cg.apply_permutation(s, perm, valid), valid, box, cfg


def _by_tag(s, valid, a):
    """Rows of a per-slot array for the valid slots, in tag order."""
    tag = s.tag.numpy()
    rows = np.asarray(a)[valid.numpy()]
    return rows[np.argsort(tag[valid.numpy()])]


def _pair_geometry(xt, box_len, cut):
    """Minimum-image distances of all ordered pairs (i != j) and the
    in-cutoff mask, for tag-ordered positions."""
    d = xt[:, None, :] - xt[None, :, :]
    d -= box_len * np.round(d / box_len)
    r = np.sqrt(np.sum(d * d, axis=-1))
    np.fill_diagonal(r, np.inf)
    return r, r < cut


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_f64_plain_passes_match_tpumd(grid, jpair):
    s, valid, box, cfg = _eam_grid(GRIDS[grid], torch.float64)
    assert (cfg.nx, cfg.ny, cfg.nz) == ((3,) * 3 if grid == "3cube"
                                        else (2,) * 3)
    xt = _by_tag(s, valid, s.x)
    n = len(xt)
    pair = _port_pair(jpair)
    tab = pair.kernel_tables(s.x)

    # pass 1 against tpumd's exact spline helper, per tag
    n0 = ec.rho_counts.plain_calls
    rho, fp, e_embed = ec.eam_rho_cellgrid(s.x, valid, box, cfg, tab, True)
    assert ec.rho_counts.plain_calls == n0 + 1
    r, inside = _pair_geometry(xt, box.lengths_np(), jpair.cutmax)
    rho_ref = np.array([np.sum(jeam._spline_val_np(
        jpair.rhor_spline[0], jpair.dr, jpair.nr, r[i][inside[i]]))
        for i in range(n)])
    np.testing.assert_allclose(_by_tag(s, valid, rho), rho_ref, rtol=1e-12)
    assert np.all(fp.numpy()[~valid.numpy()] == 0.0)

    # both passes against tpumd's matrix engine (all-pairs list)
    jbox = JBox.orthogonal(box.lo.numpy(), box.hi.numpy(), dtype=jnp.float64)
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (n, n))
    fj, ej, _, vj = jpair.compute(jnp.asarray(xt), jnp.ones(n, jnp.int32),
                                  jbox, idx, None, None, None, True, True)
    fj, vj = np.asarray(fj), np.asarray(vj)
    f, evdwl, virial, extra = pair.compute_cellgrid(s.x, valid, box, cfg,
                                                    True, True)
    assert extra is None
    np.testing.assert_allclose(_by_tag(s, valid, f), fj, rtol=0,
                               atol=1e-12 * np.abs(fj).max())
    assert float(evdwl) == pytest.approx(float(ej), rel=1e-12)
    np.testing.assert_allclose(virial.numpy(), vj, rtol=0,
                               atol=1e-12 * np.abs(vj).max())
    assert np.abs(fj).max() > 0.5 and float(ej) / n < -3.0
    # the embedding part alone: sum of F(rho_i) from tpumd's helper
    e_ref = np.sum(jeam._spline_val_np(jpair.frho_spline[0], jpair.drho,
                                       jpair.nrho, rho_ref))
    assert float(e_embed) == pytest.approx(e_ref, rel=1e-12)

    # force-only and single-flag calls return the same forces
    for ef, vf in ((False, False), (True, False), (False, True)):
        f2, e2, v2, _ = pair.compute_cellgrid(s.x, valid, box, cfg, ef, vf)
        np.testing.assert_array_equal(f2.numpy(), f.numpy())
        assert (e2 is None) != ef and (v2 is None) != vf


def _fit_bounds(jp):
    """{name: eps * max|fn|} of tpumd's Chebyshev fits (the same fits as
    PairEAM._init_cellgrid_tables makes), and the fit range."""
    lo, hi = 0.22 * jp.cutmax, jp.cutmax
    rhor, z2r = jp.rhor_spline[0], jp.z2r_spline[0]
    fns = {
        "rho_val": lambda r: jeam._spline_val_np(rhor, jp.dr, jp.nr, r),
        "rho_der": lambda r: jeam._spline_der_np(rhor, jp.dr, jp.nr, r),
        "z2_val": lambda r: jeam._spline_val_np(z2r, jp.dr, jp.nr, r),
        "z2_der": lambda r: jeam._spline_der_np(z2r, jp.dr, jp.nr, r),
    }
    used = dict(zip(("rho_val", "rho_der", "z2_val", "z2_der"),
                    jp._pallas_tabs[2:]))
    bounds = {}
    for name, fn in fns.items():
        for deg in (16, 20, 24):
            t = fit_cheb(fn, lo, hi, deg)
            if t.max_rel_err < 1e-4:
                break
        assert t.coefs == used[name]
        scale = np.abs(fn(np.linspace(lo, hi, 2049))).max()
        bounds[name] = t.max_rel_err * scale
    return bounds, lo


def test_f32_plain_passes_match_pallas_kernels(jpair):
    s, valid, box, cfg = _eam_grid(GRIDS["3cube"], torch.float32)
    pair = _port_pair(jpair)
    tab = pair.kernel_tables(s.x)
    bounds, lo = _fit_bounds(jpair)
    xt = _by_tag(s, valid, s.x.double())
    r, inside = _pair_geometry(xt, box.lengths_np(), jpair.cutmax)
    r_min = r[inside].min()
    assert r_min > lo
    nnb = inside.sum(axis=1)

    jx = jnp.asarray(s.x.numpy())
    jv = jnp.asarray(valid.numpy())
    jbox = JBox.orthogonal(box.lo.numpy(), box.hi.numpy(), dtype=jnp.float32)
    jcfg = jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    _, _, rho_c, rhod_c, z2_c, z2d_c = jpair._pallas_tabs
    cut2 = float(jpair.cutforcesq)

    rho, fp, _ = ec.eam_rho_cellgrid(s.x, valid, box, cfg, tab, False)
    assert rho.dtype == fp.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        rho_j = np.asarray(eam_rho_pallas(jx, jv, jbox, jcfg, rho_c, lo,
                                          jpair.cutmax, cut2))
        f_j = np.asarray(eam_force_pallas(jx, jv, jnp.asarray(fp.numpy()),
                                          jbox, jcfg, rhod_c, z2_c, z2d_c,
                                          lo, jpair.cutmax, cut2))
    drho = np.abs(_by_tag(s, valid, rho) - _by_tag(s, valid, rho_j))
    tol_rho = nnb * bounds["rho_val"] + 1e-5 * np.abs(rho_j).max()
    assert (drho <= tol_rho).all(), (drho.max(), tol_rho.min())

    f, _, _ = ec.eam_force_cellgrid(s.x, valid, fp, box, cfg, tab, False,
                                    False)
    fp_max = float(fp.abs().max())
    per_pair = (2 * fp_max * bounds["rho_der"] + bounds["z2_der"] / r_min
                + bounds["z2_val"] / r_min ** 2)
    df = np.abs(_by_tag(s, valid, f) - _by_tag(s, valid, f_j)).max(axis=1)
    tol_f = nnb * per_pair + 1e-5 * np.abs(f_j).max()
    assert np.abs(f_j).max() > 0.5
    assert (df <= tol_f).all(), (df.max(), tol_f.min())
