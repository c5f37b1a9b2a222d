"""Host modules of the chute slice against tpumd.

read_data of a sphere file (``Atoms # sphere`` with diameter and density,
the sphere ``Velocities`` section), the box's periodic flags and the
set-up shrink-wrap of ``boundary p p fs``, wrap_pbc and the minimum image
on mixed axes, the group commands (type, subtract) as gmask bits, fix
nve/sphere, freeze and gravity (chute, spherical, vector) on groups, and
compute erotate/sphere.  Host arrays agree bit for bit; the fixes and
the compute run in float64 through torch and jax.numpy and agree to 1e-14
relative.  The chute generator is checked against the properties its
docstring promises.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core import state as j_state
from tpumd.io import read_data as j_read_data
from tpumd.md import fix_sphere as j_fix
from tpumd.md.compute_styles import ComputeERotateSphere as JERot
from tpumd.script.parser import LammpsScript as JScript
from tpumd.utils.units import get_units as j_units
from tpumd_torch.bench_targets import IN_CHUTE, chute_data
from tpumd_torch.core import state as t_state
from tpumd_torch.interop import gran_from_numpy, state_from_numpy
from tpumd_torch.io import read_data as t_read_data
from tpumd_torch.md import fix_sphere as t_fix
from tpumd_torch.md.computes import ComputeERotateSphere as TERot
from tpumd_torch.script.parser import LammpsScript as TScript
from tpumd_torch.utils.units import get_units as t_units

torch.set_num_threads(2)


def _data(tmp_path, dims=(10, 6, 8)):
    path = tmp_path / "data.chute"
    chute_data(path, *dims)
    return str(path)


def case_read_data_sphere(tmp_path):
    path = _data(tmp_path)
    jd = j_read_data.read_data(path, "sphere")
    td = t_read_data.read_data(path, "sphere")
    assert td.natoms == jd.natoms == 480
    for k in ("x", "v", "types", "radius", "rmass", "omega", "box_lo",
              "box_hi"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jd, k),
                                      err_msg=k)
    np.testing.assert_array_equal(td.radius, 0.5)
    np.testing.assert_allclose(td.rmass, np.pi / 6.0, rtol=1e-15)
    # a sphere file holds Atoms and Velocities only
    text = open(path).read().replace("Atoms # sphere",
                                     "Masses\n\n1 1.0\n2 1.0\n\nAtoms")
    (tmp_path / "bad").write_text(text)
    with pytest.raises(NotImplementedError, match="Masses"):
        t_read_data.read_data(str(tmp_path / "bad"), "sphere")


def case_chute_generator(tmp_path):
    path = _data(tmp_path, (40, 20, 40))
    d = t_read_data.read_data(path, "sphere")
    assert d.natoms == 32000
    assert (d.types == 2).sum() == 800 and (d.types == 1).sum() == 31200
    np.testing.assert_allclose(d.box_hi[:2], (40.8, 20.4), rtol=1e-15)
    base = d.types == 2
    np.testing.assert_allclose(d.x[base, 2], 0.5, atol=0.01)
    assert (d.v[base] == 0).all() and (d.omega[base] == 0).all()
    ke = 0.5 * np.sum(d.rmass[:, None] * d.v ** 2)
    assert 23.0 < ke / d.natoms < 26.0
    assert d.x[:, 2].max() < d.box_hi[2] - 0.9
    # contacts of a 10x6x8 pack at t = 0: at most 8 per sphere, and
    # spheres of one layer 1.02 apart
    small = t_read_data.read_data(_data(tmp_path), "sphere")
    x, ell = small.x, small.box_hi - small.box_lo
    dx = x[:, None] - x[None]
    dx[..., :2] -= ell[:2] * np.round(dx[..., :2] / ell[:2])
    r = np.sqrt(np.sum(dx * dx, axis=-1))
    np.fill_diagonal(r, 9.0)
    ncontact = (r < 1.0).sum(1)
    assert ncontact.max() == 8 and ncontact.mean() > 5.0
    same_layer = np.abs(dx[..., 2]) < 0.1
    assert r[same_layer].min() >= 1.02 - 1e-12
    a, b = tmp_path / "a", tmp_path / "b"
    chute_data(a, 4, 4, 4)
    chute_data(b, 4, 4, 4)
    assert a.read_text() == b.read_text()


def _decks(tmp_path, extra=""):
    """tpumd and the port on the small chute deck, set up (run 0)."""
    deck = IN_CHUTE.format(data=_data(tmp_path)) + extra + "run 0\n"
    js = JScript()
    js.run_string(deck.replace("run 0\n", ""))
    js.sim.neighbor_mode = "cellgrid"
    js.sim.verbose = False
    js.run_string("run 0")
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(deck.replace("run 0\n", ""))
    ts.sim.verbose = False
    ts.run_string("run 0")
    return js.sim, ts.sim


def _by_tag(s, name):
    tag = np.asarray(s.tag)
    a = np.asarray(getattr(s, name))
    return a[tag > 0][np.argsort(tag[tag > 0])]


def case_boundary_groups_and_shrink_wrap(tmp_path):
    jsim, tsim = _decks(tmp_path, "group mid type 1:2\n"
                                  "group top subtract mid bottom\n")
    assert tsim.boundary == tuple(jsim.boundary) == ("p", "p", "fs")
    assert tsim.state.box.periodic == tuple(jsim.state.box.periodic) \
        == (True, True, False)
    # the upper z face sits SMALL * the first box length over the top
    for k in ("lo", "hi"):
        np.testing.assert_array_equal(
            getattr(tsim.state.box, k).numpy(),
            np.asarray(getattr(jsim.state.box, k)))
    zmax = float(tsim.state.x[:, 2].max())
    assert float(tsim.state.box.hi[2]) == pytest.approx(
        zmax + 1e-4 * (0.5 + 7 * 0.6854378162897055 + 1.0), rel=1e-12)
    assert tsim.groups == jsim.groups == {"all": 1, "bottom": 2,
                                          "active": 4, "mid": 8, "top": 16}
    np.testing.assert_array_equal(_by_tag(tsim.state, "gmask"),
                                  _by_tag(jsim.state, "gmask"))
    gm = _by_tag(tsim.state, "gmask")
    assert ((gm & 2) > 0).sum() == 60 and ((gm & 4) > 0).sum() == 420
    assert ((gm & 16) > 0).sum() == 420 and (gm & 1).all()
    assert tsim.neigh_exclude == tuple(jsim.neigh_exclude) == ((2, 2),)
    assert tsim.pair.kernel_coeffs().exclude_bits == ((2, 2),)
    assert tsim.pair.freeze_group_bit == jsim.pair.freeze_group_bit == 2


def case_interop_sweep_on_tpumd_state(tmp_path):
    """tpumd's set-up grid state, history and pair settings carried across
    by state_from_numpy and gran_from_numpy: the port's sweep on them
    equals tpumd's own in-step sweep."""
    jsim, _ = _decks(tmp_path)
    jsim.run(5)
    js, jn = jsim._carry[0], jsim._carry[1]
    arrays = {k: np.asarray(getattr(js, k)) for k in (
        "x", "v", "f", "type", "tag", "image", "gmask", "radius", "rmass",
        "omega", "torque")}
    box = {"lo": np.asarray(js.box.lo), "hi": np.asarray(js.box.hi),
           "periodic": js.box.periodic}
    ts = state_from_numpy(arrays, box, device="cpu", dtype=torch.float64)
    assert ts.box.periodic == (True, True, False)
    jp = jsim.pair
    tp = gran_from_numpy(jp.kn, jp.kt, jp.gamman, jp.gammat, jp.xmu,
                         limit_damping=jp.limit_damping,
                         freeze_bit=jp.freeze_group_bit,
                         exclude_bits=jsim.neigh_exclude,
                         max_radius=jp._max_radius)
    assert tp.max_cutoff == jp.max_cutoff == 1.0
    assert tp.kernel_coeffs().exclude_bits == ((2, 2),)
    cfg = jsim._neigh_cfg
    from tpumd_torch.ops.cellgrid import CellGridConfig
    tcfg = CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin, nx=cfg.nx,
                          ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    stags = torch.as_tensor(np.asarray(jn.shear_tags))
    assert int((stags != 0).sum()) > 0
    valid = torch.as_tensor(np.asarray(jn.valid))
    # the port's sweep walks a pair list: built here from the state
    from tpumd_torch.ops.cellgrid import pairlist_kmax, row2slot_from_tags
    from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist_plain
    natoms = int(valid.sum())
    pairs, npairs, _, over = cellgrid_pairlist_plain(
        ts.x, valid, ts.tag, None, None, ts.box, tcfg,
        pairlist_kmax(ts.box, tcfg.cutneigh, natoms) + 16, ts.gmask,
        tp.kernel_coeffs().exclude_bits)
    assert not bool(over)
    out = tp.compute_gran_cellgrid(ts, valid, stags,
                                   torch.as_tensor(np.asarray(jn.shear)),
                                   tcfg, jsim.dt, True,
                                   (pairs, npairs,
                                    row2slot_from_tags(ts.tag, natoms)))
    ref = jp.compute_gran_cellgrid(js, jn.valid, jn.shear_tags, jn.shear,
                                   cfg, jsim.dt, True,
                                   exclude_bits=cfg.exclude_bits)
    for a, b in zip(out, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())


def case_wrap_and_minimum_image():
    rng = np.random.default_rng(3)
    lo, hi = np.array([0.0, -1.0, 0.5]), np.array([5.0, 3.0, 9.0])
    for periodic in ((True, True, False), (False, True, True),
                     (True, False, False)):
        x = rng.uniform(-8.0, 14.0, (200, 3))
        d = rng.uniform(-9.0, 9.0, (200, 3))
        jbox = j_state.Box.orthogonal(lo, hi, dtype=jnp.float64,
                                      periodic=periodic)
        tbox = t_state.Box.orthogonal(lo, hi, device="cpu",
                                      dtype=torch.float64, periodic=periodic)
        js = j_state.wrap_pbc(j_state.make_state(
            x, np.zeros_like(x), np.ones(200, np.int32), jbox))
        ts = t_state.wrap_pbc(t_state.make_state(
            x, np.zeros_like(x), np.ones(200, np.int32), tbox,
            device="cpu", dtype=torch.float64))
        np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
        np.testing.assert_array_equal(ts.image.numpy(), np.asarray(js.image))
        for c, p in enumerate(periodic):
            inside = (ts.x[:, c] >= lo[c]) & (ts.x[:, c] < hi[c])
            assert bool(inside.all()) == p or not p
        np.testing.assert_array_equal(
            t_state.minimum_image(torch.as_tensor(d), tbox).numpy(),
            np.asarray(j_state.minimum_image(jnp.asarray(d), jbox)))


def _sphere_states(seed=7, n=64):
    """The same sphere state in both packages, with group bits, forces
    and torques; slots past n - 4 are empty (tag 0, type 0, rmass 0)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 6.0, (n, 3))
    v, w, f, tq = (rng.normal(size=(n, 3)) for _ in range(4))
    radius = rng.uniform(0.3, 0.7, n)
    rmass = rng.uniform(0.5, 2.0, n)
    typ = rng.integers(1, 3, n).astype(np.int32)
    gm = (1 | np.where(typ == 2, 2, 4) | rng.choice([0, 8], n)).astype(
        np.int32)
    empty = np.arange(n) >= n - 4
    for a in (v, w, f, tq, x):
        a[empty] = 0.0
    radius[empty] = rmass[empty] = 0.0
    typ[empty] = gm[empty] = 0
    tags = np.where(empty, 0, np.arange(1, n + 1)).astype(np.int32)
    jbox = j_state.Box.orthogonal(np.zeros(3), np.full(3, 6.0),
                                  dtype=jnp.float64)
    js = j_state.make_state(x, v, typ, jbox, tags=tags, radius=radius,
                            rmass=rmass, omega=w).replace(
        f=jnp.asarray(f), torque=jnp.asarray(tq), gmask=jnp.asarray(gm))
    tbox = t_state.Box.orthogonal(np.zeros(3), np.full(3, 6.0), device="cpu",
                                  dtype=torch.float64)
    ts = t_state.make_state(x, v, typ, tbox, tags=tags, radius=radius,
                            rmass=rmass, omega=w, device="cpu",
                            dtype=torch.float64).replace(
        f=torch.as_tensor(f), torque=torch.as_tensor(tq),
        gmask=torch.as_tensor(gm))
    return js, ts


def _ctx(mod, units):
    """The three things the sphere fixes read of a step context."""
    if mod is jnp:
        mass = (lambda s: jnp.where(s.rmass > 0, s.rmass, 1.0))
    else:
        mass = (lambda s: torch.where(s.rmass > 0, s.rmass, 1.0))
    return types.SimpleNamespace(dt=0.003, units=units, mass_per_atom=mass)


def _same(ts, js, fields=("x", "v", "f", "omega", "torque")):
    for k in fields:
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-14,
                                   atol=1e-14, err_msg=k)


def case_sphere_fixes():
    jctx, tctx = _ctx(jnp, j_units("lj")), _ctx(torch, t_units("lj"))
    for bit in (1, 4, 8):
        js, ts = _sphere_states()
        jn, tn = j_fix.FixNVESphere(), t_fix.FixNVESphere()
        jfr, tfr = j_fix.FixFreeze(), t_fix.FixFreeze()
        jn.groupbit = tn.groupbit = jfr.groupbit = tfr.groupbit = bit
        js, _ = jn.initial_integrate(js, None, jctx)
        ts, _ = tn.initial_integrate(ts, None, tctx)
        _same(ts, js)
        js, _ = jfr.post_force(js, None, jctx)
        ts, _ = tfr.post_force(ts, None, tctx)
        _same(ts, js)
        js, _ = jn.final_integrate(js, None, jctx)
        ts, _ = tn.final_integrate(ts, None, tctx)
        _same(ts, js)
        moved = (ts.x != _sphere_states()[1].x).any(1)
        sel = tn.group_sel(ts)
        assert bool((moved == sel).all()) and 0 < int(sel.sum()) <= 60
    for args in (("chute", "26.0"), ("spherical", "30.0", "120.0"),
                 ("vector", "1.0", "-2.0", "0.5")):
        js, ts = _sphere_states(seed=11)
        jg = j_fix.FixGravity(1.5, args[0], *args[1:])
        tg = t_fix.FixGravity("1.5", args[0], *args[1:])
        jg.groupbit = tg.groupbit = 4
        assert tg.acc == pytest.approx(jg.acc, rel=1e-15)
        js, _ = jg.post_force(js, None, jctx)
        ts, _ = tg.post_force(ts, None, tctx)
        _same(ts, js, ("f",))
    with pytest.raises(NotImplementedError, match="gravity"):
        t_fix.FixGravity("1.0", "chute")


def case_erotate_sphere():
    js, ts = _sphere_states(seed=5)
    u = t_units("lj")
    for group, bit in (("all", 1), ("g", 8)):
        jc = JERot("1", group)
        sim = types.SimpleNamespace(state=js, groups={"all": 1, "g": 8},
                                    units=j_units("lj"))
        ref = float(jc.evaluate(sim))
        got = float(TERot("1", bit).value(ts, u.mvv2e))
        assert got == pytest.approx(ref, rel=1e-14) and ref > 0


def case_unported_commands_raise(tmp_path):
    deck = IN_CHUTE.format(data=_data(tmp_path))
    for old, new, err, match in (
            ("boundary        p p fs", "boundary        p p q",
             Exception, "boundary"),
            ("compute         1 all erotate/sphere",
             "compute         1 all ke", NotImplementedError, "compute"),
            ("thermo_modify   norm no", "thermo_modify   lost ignore",
             NotImplementedError, "thermo_modify"),
            ("fix             3 active nve/sphere",
             "fix             3 active nve", NotImplementedError, "group"),
            ("group           bottom type 2",
             "group           bottom variable v", NotImplementedError,
             "group"),
            ("gran/hooke/history", "granular", NotImplementedError,
             "granular"),
            ("neigh_modify    exclude group bottom bottom",
             "neigh_modify    exclude type 2 2", NotImplementedError,
             "exclude")):
        script = TScript(device="cpu", dtype=torch.float64)
        with pytest.raises(err, match=match):
            script.run_string(deck.replace(old, new) + "run 0\n")


LJ_DECK = """
units           lj
atom_style      atomic
boundary        {boundary}
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
{extra}
fix             1 all nve
run             0
"""


@pytest.mark.parametrize("what", ["p p f", "p s p", "before units",
                                  "exclude", "after box", "kernel check"])
def test_periodic_only_paths_raise(what):
    """On the cell grid only the granular path takes a non-periodic axis
    or a neigh_modify exclusion: the lj/cut deck with either raises at
    set-up when the grid is asked for (the B1-B5 kernels add the wrap on
    every axis), also when the boundary command comes before units, and
    runs on the matrix engine, which "auto" picks for it.  The kernels'
    input check raises on a non-periodic box, and a boundary command after
    the box is made raises.  The same deck with an explicit ``boundary p p
    p`` runs on the grid."""
    ok = TScript(device="cpu", dtype=torch.float64)
    ok.run_string(LJ_DECK.format(boundary="p p p", extra=""))
    assert ok.sim.last_thermo["epair"] == pytest.approx(-6.7733681,
                                                        rel=1e-7)
    assert ok.sim._mode == "cellgrid"
    if what == "kernel check":
        from tpumd_torch.ops.cellgrid import CellGridConfig
        from tpumd_torch.ops.lj_cellgrid import check_grid_inputs
        cfg = CellGridConfig(cutneigh=2.8, skin=0.3, nx=3, ny=3, nz=3, cap=4)
        box = t_state.Box.orthogonal(np.zeros(3), np.full(3, 9.0),
                                     device="cpu", dtype=torch.float32,
                                     periodic=(True, True, False))
        x = torch.zeros((cfg.capacity, 3))
        valid = torch.zeros(cfg.capacity, dtype=torch.bool)
        with pytest.raises(NotImplementedError, match="periodic box only"):
            check_grid_inputs(x, valid, box, cfg, "charmm_cellgrid")
        check_grid_inputs(x, valid, box, cfg, "gran_cellgrid",
                          periodic_only=False)
        return
    boundary, extra, err, match = {
        "p p f": ("p p f", "", NotImplementedError, "boundary p p f"),
        "p s p": ("p s p", "", NotImplementedError, "non-periodic"),
        "exclude": ("p p p", "neigh_modify exclude group all all",
                    NotImplementedError, "exclude"),
        "after box": ("p p p", "boundary p p f", Exception,
                      "after the simulation box"),
        "before units": ("p p f", "", NotImplementedError,
                         "boundary p p f")}[what]
    deck = LJ_DECK.format(boundary=boundary, extra=extra)
    if what == "before units":
        deck = "boundary p p f\n" + deck.replace(
            "boundary        p p f\n", "")
    script = TScript(device="cpu", dtype=torch.float64)
    if what == "after box":
        with pytest.raises(err, match=match):
            script.run_string(deck)
        return
    pre, run = deck.rsplit("\nrun", 1)
    script.run_string(pre)
    script.sim.neighbor_mode = "cellgrid"
    with pytest.raises(err, match=match):
        script.run_string("run" + run)
    auto = TScript(device="cpu", dtype=torch.float64)
    auto.run_string(deck)
    assert auto.sim._mode == "matrix"
    assert np.isfinite(auto.sim.last_thermo["epair"])


CASES = {k[5:]: v for k, v in globals().items() if k.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gran_host_matches_tpumd(case, tmp_path):
    fn = CASES[case]
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()
