"""EAM's density and force passes over the cell grid's pair list (B3's
and B4's plain list sweeps), on the CPU.

fcc Cu lattices at 3.615 A of the generated Cu-like potential (cutoff
4.95 A, cutneigh 5.95 A) binned into the port's cell grid, the list built
by the plain build as a re-bin builds it, f64; the force pass takes F' of
the plain density pass (the stencil) on both sides:

* "5cube": a 5^3 lattice (3^3 grid), each atom moved by up to 0.15 A per
  axis from a numpy seed;
* "2x2x2": a 4^3 lattice, a 2^3 grid where every neighbour cell is met at
  two periodic images;
* "perturbed": a 5^3 lattice, each atom moved by up to 0.4 A;
* "3x2x3" (density pass only): a 5x4x5 lattice, a 3x2x3 grid.

* The plain list sweep equals the stencil oracle
  ``eam_force_cellgrid_plain``: forces to 1e-12 of max|f|, pair energy to
  1e-12 relative, virial to 1e-12 of its largest component, with every
  energy/virial flag.
* In f32 on the 2x2x2 grid it equals tpumd's TPU kernel
  ``eam_force_pallas`` run under ``pltpu.force_tpu_interpret_mode()``
  within the error of the Chebyshev fits that kernel evaluates, summed
  over each atom's neighbours, plus 1e-5 of max|f| (the bound of
  tests/test_torch_eam_kernel.py, which holds the 3^3 grid).
* A stale list: one atom moved 1.4 A toward a partner at a sqrt(3) (6.26
  A, beyond cutneigh) brings the pair within the cutoff; the list of the
  old positions misses it and its sweep differs from the oracle;
  ``refresh_pairlist`` rebuilds it in place (the move is past skin/2) and
  the sweep equals the oracle.

The density pass (``eam_rho_pairlist_plain``, the CPU path of
``eam_rho_cellgrid``):

* equals the stencil oracle ``eam_rho_cellgrid_plain`` in f64 (rho, F' and
  the embedding energy to 1e-12 of their largest) with and without
  eflag, and tpumd's exact spline helpers per tag: rho_i summed over the
  minimum-image neighbours and F'(rho_i) (rtol 1e-12); garbage in the
  rows' tails past npairs changes nothing;
* in f32 on the 2x2x2 grid equals tpumd's TPU kernel ``eam_rho_pallas``
  under ``pltpu.force_tpu_interpret_mode()`` within the error of its
  Chebyshev fit of rho(r) summed over each atom's neighbours plus 1e-5 of
  max rho (as tests/test_torch_eam_kernel.py holds the 3^3 grid);
* a stale list misses the moved pair's density until it is refreshed;
* through 20 steps of the 500-atom in.eam deck both passes take the list
  (one plain call of each per force evaluation; the stencil sweeps,
  made to raise, are never called) and end equal to the stencil oracles.
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
from tpumd_torch.bench_targets import EAM_A0, IN_EAM, eam_funcfl
from tpumd_torch.core.create import create_atoms_lattice
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.state import Box, make_state, wrap_pbc
from tpumd_torch.interop import eam_from_numpy
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import eam_cellgrid as ec
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

CUTNEIGH, SKIN = 5.95, 1.0
# name: (lattice cells per axis, perturbation amplitude in A, seed)
CASES = {"5cube": (5, 0.15, 11), "2x2x2": (4, 0.15, 12),
         "perturbed": (5, 0.4, 13)}
RHO_CASES = dict(CASES, **{"3x2x3": ((5, 4, 5), 0.15, 14)})
FLAGS = ((1, 1), (0, 0), (1, 0), (0, 1))


@pytest.fixture(scope="module")
def jpair(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "Cu.eam"
    eam_funcfl(path)
    p = jeam.PairEAM(1)
    p.coeff(1, 1, 1, 1, str(path))
    p.init()
    return p


def _tables(jp, like):
    return eam_from_numpy(jp.frho_spline, jp.rhor_spline, jp.z2r_spline,
                          jp.dr, jp.drho, jp.nr, jp.nrho, jp.rhomax,
                          jp.cutmax).kernel_tables(like)


def _grid(n, amp, seed, dtype=torch.float64):
    """(grid-ordered state, valid, box, grid config, list (pairs, npairs,
    rows), its status words and hold) of an n^3 Cu lattice moved by up to
    amp per axis."""
    lat = Lattice("fcc", EAM_A0, units="metal")
    hi = np.broadcast_to(np.asarray(n, dtype=float), (3,)) * lat.spacing
    x, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    x = x + np.random.default_rng(seed).uniform(-amp, amp, x.shape)
    box = Box.orthogonal(np.zeros(3), hi, device="cpu", dtype=dtype)
    assert x.shape[0] == 4 * int(np.prod(np.broadcast_to(n, (3,))))
    s = wrap_pbc(make_state(x, np.zeros_like(x), t, box, device="cpu",
                            dtype=dtype))
    cfg = cg.choose_cellgrid_config(box, CUTNEIGH, SKIN, len(x))
    s = cg.pad_state(s, cfg.capacity)
    valid0 = torch.arange(cfg.capacity) < len(x)
    perm, valid, _, over = cg.bin_permutation(s.x, valid0, s.box, cfg)
    assert not bool(over)
    s = cg.apply_permutation(s, perm, valid)
    stat = bpl.new_stat(s.x.device)
    hold = bpl.pairlist_hold(s.x, valid, s.tag, None, None, cfg)
    pairs, npairs, _, over = bpl.cellgrid_pairlist(
        s.x, valid, s.tag, None, None, box, cfg,
        cg.pairlist_kmax(box, CUTNEIGH, len(x)), stat=stat, hold=hold)
    assert not bool(over)
    plist = (pairs, npairs, cg.row2slot_from_tags(s.tag, len(x)))
    return s, valid, box, cfg, plist, stat, hold


def _same_sums(out, ref, rtol=1e-12):
    fmax = float(ref[0].abs().max())
    assert fmax > 0.1
    assert float((out[0] - ref[0]).abs().max()) <= rtol * fmax
    for a, b in zip(out[1:], ref[1:]):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= rtol * float(b.abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_list_sweep_matches_stencil_oracle(case, jpair):
    s, valid, box, cfg, plist, _, _ = _grid(*CASES[case])
    assert (min(cfg.nx, cfg.ny, cfg.nz) == 2) == (case == "2x2x2")
    tab = _tables(jpair, s.x)
    _, fp, _ = ec.eam_rho_cellgrid_plain(s.x, valid, box, cfg, tab, False)
    for ef, vf in FLAGS:
        n0 = ec.force_counts.plain_calls
        out = ec.eam_force_cellgrid(s.x, valid, fp, box, cfg, tab, ef, vf,
                                    plist)
        assert ec.force_counts.plain_calls == n0 + 1
        _same_sums(out, ec.eam_force_cellgrid_plain(s.x, valid, fp, box, cfg,
                                                    tab, ef, vf))
    with pytest.raises(ValueError, match="no pair list"):
        ec.eam_force_cellgrid(s.x, valid, fp, box, cfg, tab, 0, 0, None)


def _fit_bounds(jp):
    """{name: eps * max|fn|} of tpumd's Chebyshev fits of the force pass
    (tests/test_torch_eam_kernel.py::_fit_bounds) and the fit's lower
    end."""
    lo, hi = 0.22 * jp.cutmax, jp.cutmax
    rhor, z2r = jp.rhor_spline[0], jp.z2r_spline[0]
    fns = {
        "rho_der": lambda r: jeam._spline_der_np(rhor, jp.dr, jp.nr, r),
        "z2_val": lambda r: jeam._spline_val_np(z2r, jp.dr, jp.nr, r),
        "z2_der": lambda r: jeam._spline_der_np(z2r, jp.dr, jp.nr, r),
    }
    used = dict(zip(("rho_der", "z2_val", "z2_der"), jp._pallas_tabs[3:]))
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


def test_f32_list_sweep_matches_pallas_kernel(jpair):
    s, valid, box, cfg, plist, _, _ = _grid(*CASES["2x2x2"],
                                            dtype=torch.float32)
    tab = _tables(jpair, s.x)
    bounds, lo = _fit_bounds(jpair)
    ok = valid.numpy()
    xt = s.x.double().numpy()[ok]
    d = xt[:, None, :] - xt[None, :, :]
    L = box.lengths_np()
    d -= L * np.round(d / L)
    r = np.sqrt(np.sum(d * d, axis=-1))
    np.fill_diagonal(r, np.inf)
    inside = r < jpair.cutmax
    r_min = r[inside].min()
    assert r_min > lo
    _, fp, _ = ec.eam_rho_cellgrid_plain(s.x, valid, box, cfg, tab, False)
    jbox = JBox.orthogonal(box.lo.numpy(), box.hi.numpy(), dtype=jnp.float32)
    jcfg = jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    _, _, _, rhod_c, z2_c, z2d_c = jpair._pallas_tabs
    with pltpu.force_tpu_interpret_mode():
        f_j = np.asarray(eam_force_pallas(
            jnp.asarray(s.x.numpy()), jnp.asarray(ok), jnp.asarray(fp.numpy()),
            jbox, jcfg, rhod_c, z2_c, z2d_c, lo, jpair.cutmax,
            float(jpair.cutforcesq)))
    f, _, _ = ec.eam_force_cellgrid(s.x, valid, fp, box, cfg, tab, False,
                                    False, plist)
    assert f.dtype == torch.float32
    per_pair = (2 * float(fp.abs().max()) * bounds["rho_der"]
                + bounds["z2_der"] / r_min + bounds["z2_val"] / r_min ** 2)
    df = np.abs(f.numpy()[ok] - f_j[ok]).max(axis=1)
    tol = inside.sum(axis=1) * per_pair + 1e-5 * np.abs(f_j).max()
    assert np.abs(f_j).max() > 0.5
    assert (df <= tol).all(), (df.max(), tol.min())


def test_stale_list_misses_a_pair_until_refreshed(jpair):
    s, valid, box, cfg, plist, stat, hold = _grid(5, 0.0, 0)
    far = EAM_A0 * np.sqrt(3.0)
    assert far > CUTNEIGH
    x = s.x
    ok = torch.nonzero(valid).reshape(-1)
    i = int(ok[0])
    d = x[i] - x[ok]
    d = d - box.lengths * torch.round(d / box.lengths)
    k = int(torch.nonzero((d.norm(dim=1) - far).abs() < 1e-6)[0])
    j = int(ok[k])
    moved = x.clone()
    moved[j] = x[j] + 1.4 * d[k] / d[k].norm()
    dd = moved[i] - moved[j]
    dd = dd - box.lengths * torch.round(dd / box.lengths)
    assert float(dd.norm()) < jpair.cutmax
    tab = _tables(jpair, x)
    _, fp, _ = ec.eam_rho_cellgrid_plain(moved, valid, box, cfg, tab, False)
    oracle = ec.eam_force_cellgrid_plain(moved, valid, fp, box, cfg, tab,
                                         True, True)
    stale = ec.eam_force_cellgrid(moved, valid, fp, box, cfg, tab, True, True,
                                  plist)
    fmax = float(oracle[0].abs().max())
    assert float((stale[0] - oracle[0]).abs().max()) > 1e-6 * fmax
    bpl.refresh_pairlist(moved, valid, box, cfg, plist[0], plist[1], stat,
                         hold)
    assert int(stat[2]) == 1 and torch.equal(hold.x, moved)
    _same_sums(ec.eam_force_cellgrid(moved, valid, fp, box, cfg, tab, True,
                                     True, plist), oracle)


def _by_tag(s, valid, a):
    """Rows of a per-slot array for the valid slots, in tag order."""
    ok = valid.numpy()
    return np.asarray(a)[ok][np.argsort(s.tag.numpy()[ok])]


def _neighbours(xt, box, cut):
    """Minimum-image distances of all ordered pairs of tag-ordered
    positions (the diagonal infinite) and the in-cutoff mask."""
    d = xt[:, None, :] - xt[None, :, :]
    L = box.lengths_np()
    d -= L * np.round(d / L)
    r = np.sqrt(np.sum(d * d, axis=-1))
    np.fill_diagonal(r, np.inf)
    return r, r < cut


def _same_rho(out, ref, rtol=1e-12):
    for a, b in zip(out, ref):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= rtol * float(b.abs().max())


@pytest.mark.parametrize("case", sorted(RHO_CASES))
def test_rho_list_sweep_matches_stencil_and_tpumd(case, jpair):
    s, valid, box, cfg, plist, _, _ = _grid(*RHO_CASES[case])
    assert min(cfg.nx, cfg.ny, cfg.nz) == (2 if case in ("2x2x2", "3x2x3")
                                           else 3)
    tab = _tables(jpair, s.x)
    for ef in (True, False):
        n0 = ec.rho_counts.plain_calls
        out = ec.eam_rho_cellgrid(s.x, valid, box, cfg, tab, ef, plist)
        assert ec.rho_counts.plain_calls == n0 + 1
        _same_rho(out, ec.eam_rho_cellgrid_plain(s.x, valid, box, cfg, tab,
                                                 ef))
        assert float(out[1][~valid].abs().max()) == 0.0
    # tpumd's exact splines, per tag
    xt = _by_tag(s, valid, s.x)
    r, inside = _neighbours(xt, box, jpair.cutmax)
    rho_ref = np.array([np.sum(jeam._spline_val_np(
        jpair.rhor_spline[0], jpair.dr, jpair.nr, r[i][inside[i]]))
        for i in range(len(xt))])
    np.testing.assert_allclose(_by_tag(s, valid, out[0]), rho_ref,
                               rtol=1e-12)
    np.testing.assert_allclose(
        _by_tag(s, valid, out[1]),
        jeam._spline_der_np(jpair.frho_spline[0], jpair.drho, jpair.nrho,
                            rho_ref), rtol=1e-12)
    # the rows' tails past npairs are never read
    pairs = plist[0].clone()
    tail = (torch.arange(pairs.shape[1])[None, :]
            >= plist[1][:, None].long())
    pairs[tail] = torch.as_tensor(np.random.default_rng(1).integers(
        -2**31, 2**31 - 1, int(tail.sum())), dtype=torch.int32)
    _same_rho(ec.eam_rho_cellgrid(s.x, valid, box, cfg, tab, True,
                                  (pairs,) + plist[1:]),
              ec.eam_rho_cellgrid(s.x, valid, box, cfg, tab, True, plist),
              rtol=0.0)
    with pytest.raises(ValueError, match="no pair list"):
        ec.eam_rho_cellgrid(s.x, valid, box, cfg, tab, False, None)


def test_f32_rho_list_sweep_matches_pallas_kernel(jpair):
    s, valid, box, cfg, plist, _, _ = _grid(*CASES["2x2x2"],
                                            dtype=torch.float32)
    tab = _tables(jpair, s.x)
    lo, hi = 0.22 * jpair.cutmax, jpair.cutmax
    rhor = jpair.rhor_spline[0]

    def rho_fn(r):
        return jeam._spline_val_np(rhor, jpair.dr, jpair.nr, r)

    for deg in (16, 20, 24):
        fit = fit_cheb(rho_fn, lo, hi, deg)
        if fit.max_rel_err < 1e-4:
            break
    assert fit.coefs == jpair._pallas_tabs[2]
    eps = fit.max_rel_err * np.abs(rho_fn(np.linspace(lo, hi, 2049))).max()
    xt = _by_tag(s, valid, s.x.double())
    r, inside = _neighbours(xt, box, jpair.cutmax)
    assert r[inside].min() > lo
    jbox = JBox.orthogonal(box.lo.numpy(), box.hi.numpy(), dtype=jnp.float32)
    jcfg = jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    with pltpu.force_tpu_interpret_mode():
        rho_j = np.asarray(eam_rho_pallas(
            jnp.asarray(s.x.numpy()), jnp.asarray(valid.numpy()), jbox, jcfg,
            jpair._pallas_tabs[2], lo, hi, float(jpair.cutforcesq)))
    rho, fp, _ = ec.eam_rho_cellgrid(s.x, valid, box, cfg, tab, False, plist)
    assert rho.dtype == fp.dtype == torch.float32
    drho = np.abs(_by_tag(s, valid, rho) - _by_tag(s, valid, rho_j))
    tol = inside.sum(axis=1) * eps + 1e-5 * np.abs(rho_j).max()
    assert np.abs(rho_j).max() > 0.1
    assert (drho <= tol).all(), (drho.max(), tol.min())


def test_stale_list_misses_a_density_pair_until_refreshed(jpair):
    s, valid, box, cfg, plist, stat, hold = _grid(5, 0.0, 0)
    far = EAM_A0 * np.sqrt(3.0)
    x = s.x
    ok = torch.nonzero(valid).reshape(-1)
    i = int(ok[0])
    d = x[i] - x[ok]
    d = d - box.lengths * torch.round(d / box.lengths)
    k = int(torch.nonzero((d.norm(dim=1) - far).abs() < 1e-6)[0])
    j = int(ok[k])
    moved = x.clone()
    moved[j] = x[j] + 1.4 * d[k] / d[k].norm()
    tab = _tables(jpair, x)
    oracle = ec.eam_rho_cellgrid_plain(moved, valid, box, cfg, tab, True)
    stale = ec.eam_rho_cellgrid(moved, valid, box, cfg, tab, True, plist)
    # the pair (i, j) came within the cutoff from beyond cutneigh: both
    # densities miss its term
    gap = (oracle[0] - stale[0]).abs()
    assert float(gap[i]) > 1e-6 * float(oracle[0].max())
    assert float(gap[j]) > 1e-6 * float(oracle[0].max())
    bpl.refresh_pairlist(moved, valid, box, cfg, plist[0], plist[1], stat,
                         hold)
    assert int(stat[2]) == 1
    _same_rho(ec.eam_rho_cellgrid(moved, valid, box, cfg, tab, True, plist),
              oracle)


def test_eam_deck_sweeps_the_list_in_both_passes(tmp_path, monkeypatch):
    eam_funcfl(tmp_path / "Cu.eam")
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(IN_EAM.format(n=5, potential=tmp_path / "Cu.eam")
                      .replace("thermo          50", "thermo          10"))
    sim = script.sim
    sim.verbose = False

    def stencil(*args, **kw):
        raise AssertionError("a stencil sweep ran on the main path")
    oracles = (ec.eam_rho_cellgrid_plain, ec.eam_force_cellgrid_plain)
    monkeypatch.setattr(ec, "eam_rho_cellgrid_plain", stencil)
    monkeypatch.setattr(ec, "eam_force_cellgrid_plain", stencil)
    n_rho, n_force = ec.rho_counts.plain_calls, ec.force_counts.plain_calls
    script.run_string("run 20")
    # setup, 20 steps and the thermo rows of steps 10 and 20
    evals = ec.rho_counts.plain_calls - n_rho
    assert evals == ec.force_counts.plain_calls - n_force == 1 + 20 + 2
    assert sim.step == 20 and np.isfinite(sim.last_thermo["etotal"])
    monkeypatch.undo()
    s, neigh, _ = sim._carry
    cfg = sim._neigh_cfg
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    tab = sim.pair.kernel_tables(s.x)
    rho = ec.eam_rho_cellgrid(s.x, neigh.valid, s.box, cfg, tab, True, plist)
    ref = oracles[0](s.x, neigh.valid, s.box, cfg, tab, True)
    _same_rho(rho, ref)
    _same_sums(ec.eam_force_cellgrid(s.x, neigh.valid, ref[1], s.box, cfg,
                                     tab, True, True, plist),
               oracles[1](s.x, neigh.valid, ref[1], s.box, cfg, tab, True,
                          True))
