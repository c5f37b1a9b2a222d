"""The granular modules of the port against tpumd, on the CPU in f64.

* B6's plain version with ``GranCoeffs.hertz`` (gran/hertz/history over
  the grid's pair list) against tpumd's ``gran_compact_sums`` with
  ``hertz=True``, on the grid-ordered state of a small chute pack after 30
  steps, the history as it is and scaled by 40 (slipping contacts), both
  shearupdate values: forces, torques and shear to 1e-12 of their
  largest, equal contact tags.
* The sweep's count of spheres past KH = 12 contacts (history lost): 0
  for 12 touching spheres, 14 for 14, and the run's one warning.
* The matrix engine's ``compute_gran`` of gran/hertz/history and of
  gran/hooke (no history) against tpumd's on a seeded overlapping sphere
  pack with a brute-force neighbor matrix: to 1e-12.
* fix wall/gran (hooke, hooke/history, hertz/history; zplane, a two-sided
  xplane, zcylinder; plain, wiggle, shear; on group all and a subgroup)
  and fix wall/lj93, lj126, harmonic and reflect against tpumd's on a
  seeded sphere state: forces, torques, wall history and energies to
  1e-13.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core import state as j_state
from tpumd.core.state import Box as JBox
from tpumd.md import fix_wall as j_wall
from tpumd.md.fix_wall_gran import FixWallGran as JWallGran
from tpumd.models.pair_gran import PairGranHertzHistory as JHertz
from tpumd.models.pair_gran import PairGranHooke as JHooke
from tpumd.ops import cellgrid as jcg
from tpumd.ops.cellgrid_gran import gran_compact_sums as j_sums
from tpumd.utils.units import get_units as j_units
from tpumd_torch.bench_targets import IN_CHUTE, chute_data
from tpumd_torch.core import state as t_state
from tpumd_torch.core.state import Box
from tpumd_torch.md import fix_wall as t_wall
from tpumd_torch.md.fix_wall_gran import FixWallGran as TWallGran
from tpumd_torch.models.pair_gran import PairGranHertzHistory as THertz
from tpumd_torch.models.pair_gran import PairGranHooke as THooke
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops.cellgrid_gran import GranCoeffs, gran_pairlist_plain
from tpumd_torch.script.parser import LammpsScript
from tpumd_torch.utils.units import get_units as t_units

torch.set_num_threads(2)
DT = 1e-4


def _close(got, ref, tol=1e-12):
    ref = np.asarray(ref, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


# ------------------------------------------------------------ B6, HERTZ
@functools.lru_cache(maxsize=None)
def _chute_pack():
    """The grid-ordered f64 state, grid state and config of a 10x6x8
    chute pack after 30 steps (live contact history)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        chute_data(f"{tmp}/data.chute", 10, 6, 8)
        script = LammpsScript(device="cpu", dtype=torch.float64)
        script.run_string(IN_CHUTE.format(data=f"{tmp}/data.chute"))
        script.sim.verbose = False
        script.run_string("run 30")
    sim = script.sim
    s, neigh, _ = sim._carry
    return s, neigh, sim._neigh_cfg, sim.pair


@pytest.mark.parametrize("scale", [1.0, 40.0])
@pytest.mark.parametrize("shearupdate", [True, False])
def test_b6_plain_hertz_matches_tpumd(scale, shearupdate):
    s, neigh, cfg, pair = _chute_pack()
    c = pair.kernel_coeffs()._replace(gammat=25.0, hertz=True)
    assert c.freeze_bit and c.exclude_bits
    natoms = int(neigh.valid.sum())
    pairs, npairs, _, over = bpl.cellgrid_pairlist_plain(
        s.x, neigh.valid, s.tag, None, None, s.box, cfg,
        cg.pairlist_kmax(s.box, cfg.cutneigh, natoms) + 16, s.gmask,
        c.exclude_bits)
    assert not bool(over)
    rm = torch.where(s.rmass > 0, s.rmass, 1.0)
    planes = (s.v, s.omega, s.radius, rm, s.gmask)
    shear = neigh.shear * scale
    out = gran_pairlist_plain(s.x, s.tag, neigh.shear_tags, shear, s.box, c,
                              planes, DT, shearupdate, pairs, npairs)
    a = (lambda t: jnp.asarray(t.numpy()))
    jbox = JBox.orthogonal(s.box.lo.numpy(), s.box.hi.numpy(),
                           dtype=jnp.float64, periodic=s.box.periodic)
    jcfg = jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    jplanes = (a(s.v[:, 0]), a(s.v[:, 1]), a(s.v[:, 2]), a(s.omega[:, 0]),
               a(s.omega[:, 1]), a(s.omega[:, 2]), a(s.radius), a(rm),
               a(s.gmask).astype(jnp.float64))
    params = dict(kn=c.kn, kt=c.kt, gamman=c.gamman, gammat=c.gammat,
                  xmu=c.xmu, limit_damping=c.limit_damping,
                  freeze_bit=c.freeze_bit, exclude_bits=c.exclude_bits,
                  hertz=True)
    ref = j_sums(a(s.x), a(s.tag), a(neigh.valid), a(neigh.shear_tags),
                 a(shear), jbox, jcfg, params, jplanes, DT, shearupdate)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for got, want in zip(out[:2] + out[3:], ref[:2] + ref[3:]):
        _close(got, want)
    # the Hertzian factor changed the forces
    hooke = gran_pairlist_plain(s.x, s.tag, neigh.shear_tags, shear, s.box,
                                c._replace(hertz=False), planes, DT,
                                shearupdate, pairs, npairs)
    assert float((hooke[0] - out[0]).abs().max()) > 1e-3 * float(
        out[0].abs().max())


LATTICE_PACK = """
units           lj
atom_style      sphere
boundary        p p p
lattice         {lat}
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
pair_style      gran/hertz/history 2000.0 NULL 50.0 NULL 0.5 1
pair_coeff      * *
fix             1 all nve/sphere
neighbor        0.3 bin
neigh_modify    delay 0 every 1
timestep        0.0001
thermo          1
run             1
"""


@pytest.mark.parametrize("lat, touching", [("fcc 1.6", 12), ("bcc 2.2", 14)])
def test_contacts_past_kh_are_flagged(lat, touching):
    """Unit spheres on an fcc lattice of nearest distance 0.96 touch 12
    others, which fills each history row and loses nothing; on a bcc
    lattice of cube edge 0.97 they touch 14, and the sweep records 14 in
    the pair's hist_over and the run warns once that history is lost."""
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(LATTICE_PACK.format(lat=lat))
    sim = script.sim
    s, neigh, _ = sim._carry
    assert sim._ctx.is_cellgrid
    live = (neigh.shear_tags != 0).sum(1)[neigh.valid]
    assert int(live.min()) == int(live.max()) == 12
    warned = [ln for ln in sim.log_lines if "lose shear history" in ln]
    if touching > 12:
        assert int(sim.pair.hist_over) == touching
        assert len(warned) == 1 and f"touched {touching}" in warned[0]
    else:
        assert int(sim.pair.hist_over) == 0 and not warned


# -------------------------------------------------- matrix compute_gran
def _pack(seed=3, n=160):
    """Seeded overlapping spheres in a 5^3 box, periodic in x and y, with
    a brute-force (N, K) neighbor matrix of the pairs within the contact
    distance plus 0.2 (self-index padding), a history and a frozen bit."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 5.0, (n, 3))
    radius = rng.uniform(0.35, 0.6, n)
    arrays = dict(
        x=x, v=rng.normal(size=(n, 3)), f=np.zeros((n, 3)),
        type=np.ones(n, np.int32), tag=np.arange(1, n + 1, dtype=np.int32),
        image=np.zeros((n, 3), np.int32), radius=radius,
        rmass=4.0 / 3.0 * np.pi * radius ** 3, omega=rng.normal(size=(n, 3)),
        torque=np.zeros((n, 3)),
        gmask=(1 | np.where(rng.uniform(size=n) < 0.2, 2, 0)).astype(
            np.int32))
    d = x[:, None] - x[None]
    d[..., :2] -= 5.0 * np.round(d[..., :2] / 5.0)
    r = np.linalg.norm(d, axis=-1)
    near = (r < radius[:, None] + radius[None] + 0.2) & ~np.eye(n, dtype=bool)
    k = int(near.sum(1).max())
    idx = np.tile(np.arange(n)[:, None], (1, k)).astype(np.int32)
    for i in range(n):
        js = np.nonzero(near[i])[0]
        idx[i, :len(js)] = js
    shear = rng.normal(scale=0.02, size=(n, k, 3))
    shear[idx == np.arange(n)[:, None]] = 0.0
    return arrays, idx, shear


@pytest.mark.parametrize("style", ["hertz", "hooke"])
@pytest.mark.parametrize("shearupdate", [True, False])
def test_matrix_compute_gran_matches_tpumd(style, shearupdate):
    arrays, idx, shear = _pack()
    box = dict(lo=np.zeros(3), hi=np.full(3, 5.0),
               periodic=(True, True, False))
    jbox = j_state.Box.orthogonal(box["lo"], box["hi"], dtype=jnp.float64,
                                  periodic=box["periodic"])
    js = j_state.make_state(arrays["x"], arrays["v"], arrays["type"], jbox,
                            radius=arrays["radius"], rmass=arrays["rmass"],
                            omega=arrays["omega"]).replace(
        gmask=jnp.asarray(arrays["gmask"]))
    from tpumd_torch.interop import state_from_numpy
    ts = state_from_numpy(arrays, box, device="cpu", dtype=torch.float64)
    jp = (JHertz if style == "hertz" else JHooke)(1)
    tp = (THertz if style == "hertz" else THooke)(1)
    for p in (jp, tp):
        p.settings(2000.0, "NULL", 50.0, "NULL", 0.5, 1)
        p.freeze_group_bit = 2
    ref = jp.compute_gran(js, jnp.asarray(idx), jnp.asarray(shear), DT,
                          shearupdate)
    got = tp.compute_gran(ts, torch.as_tensor(idx), torch.as_tensor(shear),
                          DT, shearupdate)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    if shearupdate and style == "hertz":
        _close(got[2], ref[2])
    else:
        # the history comes back as it went in (tpumd zeroes the slots
        # out of contact; neither package reads it back)
        assert torch.equal(got[2], torch.as_tensor(shear))
    touching = int((np.asarray(ref[0]) != 0).any(1).sum())
    assert touching > 100


# ---------------------------------------------------------- fix walls
def _spheres(seed=5, n=300):
    """Seeded spheres in [-3, 3]^2 x [0, 4] with velocities, spins,
    forces, torques and a group bit; the same state in both packages."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.uniform(-3.0, 3.0, (n, 2)),
                         rng.uniform(0.0, 4.0, n)])
    radius = rng.uniform(0.3, 0.7, n)
    v, w, f, tq = (rng.normal(size=(n, 3)) for _ in range(4))
    gm = (1 | np.where(rng.uniform(size=n) < 0.5, 4, 0)).astype(np.int32)
    rmass = rng.uniform(0.5, 2.0, n)
    typ = np.ones(n, np.int32)
    jbox = j_state.Box.orthogonal(np.array([-3.0, -3.0, 0.0]),
                                  np.array([3.0, 3.0, 4.0]),
                                  dtype=jnp.float64,
                                  periodic=(False, False, False))
    js = j_state.make_state(x, v, typ, jbox, radius=radius, rmass=rmass,
                            omega=w).replace(f=jnp.asarray(f),
                                             torque=jnp.asarray(tq),
                                             gmask=jnp.asarray(gm))
    tbox = t_state.Box.orthogonal(np.array([-3.0, -3.0, 0.0]),
                                  np.array([3.0, 3.0, 4.0]), device="cpu",
                                  dtype=torch.float64,
                                  periodic=(False, False, False))
    ts = t_state.make_state(x, v, typ, tbox, radius=radius, rmass=rmass,
                            omega=w, device="cpu",
                            dtype=torch.float64).replace(
        f=torch.as_tensor(f), torque=torch.as_tensor(tq),
        gmask=torch.as_tensor(gm))
    return js, ts, rng.normal(scale=0.05, size=(n, 3))


def _ctx(mod):
    if mod is jnp:
        mass = (lambda s: jnp.where(s.rmass > 0, s.rmass, 1.0))
        units = j_units("lj")
    else:
        mass = (lambda s: torch.where(s.rmass > 0, s.rmass, 1.0))
        units = t_units("lj")
    return types.SimpleNamespace(dt=0.002, units=units, mass_per_atom=mass)


WALLS = {"zplane": ("zplane", "0.2", "NULL"),
         "xplane": ("xplane", "-2.5", "2.6"),
         "zcylinder": ("zcylinder", "2.4")}
OPTIONS = {"plain": (), "wiggle_z": ("wiggle", "z", "0.3", "0.5"),
           "wiggle_x": ("wiggle", "x", "0.2", "0.7"),
           "shear": ("shear", "y", "0.4")}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("wall", sorted(WALLS))
@pytest.mark.parametrize("model", ["hooke", "hooke/history",
                                   "hertz/history"])
def test_fix_wall_gran_matches_tpumd(model, wall, option):
    args = (model, "2000.0", "NULL", "50.0", "NULL", "0.5", "1",
            *WALLS[wall], *OPTIONS[option])
    jfx, tfx = JWallGran(*args), TWallGran(*args)
    tfx.id = "w"
    jctx, tctx = _ctx(jnp), _ctx(torch)
    for bit in (1, 4):
        js, ts, hist = _spheres()
        jfx.groupbit = tfx.groupbit = bit
        jstate = (jnp.asarray(hist), jnp.asarray(37, jnp.int32))
        ts = ts.replace(peratom={tfx.history_key: torch.as_tensor(hist)})
        for hook in ("setup_post_force", "post_force"):
            jout, jfs = getattr(jfx, hook)(
                js, jfx.set_step(jstate, 37), jctx)
            tout, tstep = getattr(tfx, hook)(ts, tfx.set_step(0, 37), tctx)
            assert tstep == 37
            _close(tout.f, jout.f, 1e-13)
            _close(tout.torque, jout.torque, 1e-13)
            if model != "hooke":
                _close(tout.peratom[tfx.history_key], jfs[0], 1e-13)
        touched = (np.asarray(jout.f) != np.asarray(js.f)).any(1).sum()
        assert touched > 5


FACES = [("zlo", "EDGE", 1.0, 1.0, 2.5), ("zhi", "3.6", 0.7, 1.1, 1.5),
         ("xlo", "-2.0", 1.3, 0.9, 2.0)]


@pytest.mark.parametrize("style", ["wall/lj93", "wall/lj126",
                                   "wall/harmonic", "wall/reflect"])
def test_fix_wall_matches_tpumd(style):
    jcls = {"wall/lj93": j_wall.FixWallLJ93, "wall/lj126": j_wall.FixWallLJ126,
            "wall/harmonic": j_wall.FixWallHarmonic,
            "wall/reflect": j_wall.FixWallReflect}[style]
    tcls = {"wall/lj93": t_wall.FixWallLJ93, "wall/lj126": t_wall.FixWallLJ126,
            "wall/harmonic": t_wall.FixWallHarmonic,
            "wall/reflect": t_wall.FixWallReflect}[style]
    walls = [w[:2] for w in FACES] if style == "wall/reflect" else FACES
    args = [str(t) for w in walls for t in w] + ["units", "box"]
    parsed = t_wall.parse_walls(style, args, spacing=(2.0, 2.0, 2.0))
    assert [(w[0], str(w[1])) for w in parsed] == [w[:2] for w in walls]
    jfx, tfx = jcls(walls), tcls(parsed)
    jctx, tctx = _ctx(jnp), _ctx(torch)
    for bit in (1, 4):
        js, ts, _ = _spheres(seed=9)
        jfx.groupbit = tfx.groupbit = bit
        if style == "wall/reflect":
            # atoms pushed past the walls
            shift = np.where(np.arange(300) % 3 == 0, 1.0, -1.0)
            x = np.asarray(js.x) + np.outer(shift, [1.0, 0.0, 0.8])
            js = js.replace(x=jnp.asarray(x))
            ts = ts.replace(x=torch.as_tensor(x))
            jout, _ = jfx.post_integrate(js, None, jctx)
            tout, _ = tfx.post_integrate(ts, None, tctx)
            for k in ("x", "v"):
                _close(getattr(tout, k), getattr(jout, k), 0.0)
            assert (tout.v.numpy() != ts.v.numpy()).any(1).sum() > 10
            continue
        jout, _ = jfx.post_force(js, None, jctx)
        tout, _ = tfx.post_force(ts, None, tctx)
        _close(tout.f, jout.f, 1e-13)
        e = float(tfx.energy(tout))
        assert e == pytest.approx(float(jfx.energy(jout, jctx)), rel=1e-13)
        assert (tout.f.numpy() != ts.f.numpy()).any(1).sum() > 10
    # numbers are lattice lengths unless units box; EDGE stays the face
    lat = t_wall.parse_walls(style, args[:-2], spacing=(2.0, 2.0, 2.0))
    assert [w[1] for w in lat] == ["EDGE", 7.2, -4.0]
    with pytest.raises(NotImplementedError, match="variable"):
        t_wall.parse_walls(style, ["zlo", "v_z"] + args[2:])
