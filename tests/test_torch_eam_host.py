"""The EAM host part of the port against tpumd: readers, spline tables,
the state bridge, and the generated potential.

The potential files are written by ``bench_targets.eam_funcfl`` and
``eam_setfl`` (a Cu-like element, since the published Cu_u3.eam is not in
the repository).  The port's readers and table builders repeat tpumd's
numpy code, so everything here is compared bit for bit.
"""

import numpy as np
import pytest
import torch

import tpumd.models.pair_eam as jeam
import tpumd_torch.models.pair_eam as team
from tpumd_torch import bench_targets as bt
from tpumd_torch.interop import eam_from_numpy
from tpumd_torch.models.registry import create_pair_style

TABLES = ("frho_spline", "rhor_spline", "z2r_spline", "dr", "drho", "nr",
          "nrho", "rhomax", "cutmax", "cutforcesq", "type2frho", "type2rhor",
          "type2z2r")
STYLES = {"eam": ("funcfl", ()), "eam/alloy": ("setfl", ("Cu",)),
          "eam/fs": ("fs", ("Cu",))}
JCLASSES = {"eam": jeam.PairEAM, "eam/alloy": jeam.PairEAMAlloy,
            "eam/fs": jeam.PairEAMFS}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("eam")
    out = {"funcfl": d / "Cu.eam", "setfl": d / "Cu.eam.alloy",
           "fs": d / "Cu.eam.fs"}
    bt.eam_funcfl(out["funcfl"])
    bt.eam_setfl(out["setfl"])
    bt.eam_setfl(out["fs"], fs=True)
    return out


def _pairs(style, files, ntypes=1):
    """(tpumd's pair, the port's pair) of a style after coeff and init,
    every type on the one element."""
    kind, elems = STYLES[style]
    pairs = (JCLASSES[style](ntypes), create_pair_style(style, ntypes, []))
    for p in pairs:
        p.coeff(1, ntypes, 1, ntypes, str(files[kind]), *elems * ntypes)
        p.init()
    return pairs


def _assert_same(a, b, keys):
    for k in keys:
        va, vb = getattr(a, k), getattr(b, k)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert type(va) is type(vb) and va == vb, k


def test_interpolate_and_grid_interp_bit_equal():
    rng = np.random.default_rng(3)
    f = np.concatenate([[0.0], np.cumsum(rng.normal(size=60))])
    for n, delta in ((60, 0.01), (7, 0.3)):
        np.testing.assert_array_equal(team._interpolate(n, delta, f),
                                      jeam._interpolate(n, delta, f))
    for args in ((f, 0.01, 60, 75, 0.008), (f, 0.02, 60, 30, 0.04)):
        np.testing.assert_array_equal(team._grid_interp(*args),
                                      jeam._grid_interp(*args))
    r = rng.uniform(0.0, 0.7, 50)
    sp = jeam._interpolate(60, 0.01, f)
    for name in ("_spline_val_np", "_spline_der_np"):
        np.testing.assert_array_equal(getattr(team, name)(sp, 0.01, 60, r),
                                      getattr(jeam, name)(sp, 0.01, 60, r))


def test_readers_bit_equal(files):
    _assert_same(team._Funcfl(files["funcfl"]), jeam._Funcfl(files["funcfl"]),
                 ("mass", "nrho", "drho", "nr", "dr", "cut", "frho", "zr",
                  "rhor"))
    keys = ("elements", "nrho", "drho", "nr", "dr", "cut", "mass", "frho",
            "rhor", "z2r")
    _assert_same(team._Setfl(files["setfl"]), jeam._Setfl(files["setfl"]),
                 keys)
    _assert_same(team._Setfl(files["fs"], fs=True),
                 jeam._SetflFS(files["fs"]), keys)


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("ntypes", [1, 2])
def test_tables_bit_equal(style, ntypes, files):
    """_file2array (funcfl) and the setfl/fs table builds give tpumd's
    tables and type maps, and the masses the parser hands on."""
    jp, tp = _pairs(style, files, ntypes)
    _assert_same(tp, jp, TABLES)
    np.testing.assert_array_equal(tp.mass, jp.mass)
    assert tp.mass[1] == bt.EAM_MASS and tp.max_cutoff == 4.95


def test_eam_from_numpy_gives_the_file_tables(files):
    jp, tp = _pairs("eam", files)
    bridged = eam_from_numpy(jp.frho_spline, jp.rhor_spline, jp.z2r_spline,
                             jp.dr, jp.drho, jp.nr, jp.nrho, jp.rhomax,
                             jp.cutmax)
    _assert_same(bridged, tp, TABLES)
    a = bridged.kernel_tables(torch.zeros((), dtype=torch.float64))
    b = tp.kernel_tables(torch.zeros((), dtype=torch.float64))
    for k in a._fields:
        va, vb = getattr(a, k), getattr(b, k)
        assert (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                else va == vb), k


def test_generated_potential_is_cu_like(files):
    """The static fcc crystal at a0 = 3.615 A: -3.54 eV/atom at zero
    pressure (dE/da = 0), evaluated from the exact tables; the F grid
    covers 2.5 times its host density; phi is repulsive; tpumd's
    Chebyshev fits (the Pallas kernels' tables) succeed."""
    jp, tp = _pairs("eam", files)
    assert jp._pallas_tabs is not None and jp.supports_cellgrid
    m = np.arange(-3, 4)
    n2 = (m[:, None, None] ** 2 + m[None, :, None] ** 2
          + m[None, None, :] ** 2)
    even = ((m[:, None, None] + m[None, :, None] + m[None, None, :]) % 2
            == 0) & (n2 > 0)
    shell, mult = np.unique(n2[even], return_counts=True)

    def energy(a):
        r = 0.5 * a * np.sqrt(shell)
        keep = r < tp.cutmax
        r, k = r[keep], mult[keep]
        rho = np.sum(k * team._spline_val_np(tp.rhor_spline[0], tp.dr,
                                             tp.nr, r))
        phi = team._spline_val_np(tp.z2r_spline[0], tp.dr, tp.nr, r) / r
        emb = team._spline_val_np(tp.frho_spline[0], tp.drho, tp.nrho,
                                  np.array([rho]))[0]
        return emb + 0.5 * np.sum(k * phi), rho

    e0, rho0 = energy(bt.EAM_A0)
    assert e0 == pytest.approx(-3.54, abs=1e-6)
    h = 1e-4
    de_da = (energy(bt.EAM_A0 + h)[0] - energy(bt.EAM_A0 - h)[0]) / (2 * h)
    assert abs(de_da) < 1e-5
    assert rho0 == pytest.approx(1.0, rel=1e-6)
    assert tp.rhomax >= 2.49 * rho0
    r = np.linspace(0.5, 4.94, 400)
    assert (team._spline_val_np(tp.z2r_spline[0], tp.dr, tp.nr, r) > 0).all()
