"""The matrix neighbor engine's modules against tpumd's, on the CPU in f64.

Inputs are made with numpy from seeds and given to both packages:

* ``choose_config`` gives the same config (cells, capacities, block,
  image shifts) and ``build_neighbors`` the same list on a periodic box,
  one non-periodic axis, small boxes that need periodic images on every
  axis or on two, a triclinic box, group-pair exclusions and special
  tags.  tpumd builds orthogonal boxes without images with its roll-based
  build, whose order within a row differs, so rows are compared as sets;
  the special code of every (i, j) pair, the largest count and the
  overflow flag (also when K or the cell capacity is too small) are equal;
* ``displacement_exceeded`` agrees, across a periodic wrap too;
* ``pair_sums`` (lj/cut with two types, arithmetic mixing and shift) and
  ``compute_gran`` (gran/hooke/history with the frozen group, both
  shearupdate values, with and without limit_damping, the history as it
  is and scaled to slip) give forces, torques, energies, virial and
  history to 1e-12 of their largest value on tpumd's list carried over
  through ``interop``, with and without special weights and on the image
  copies of a small box;
* ``_remap_shear`` carries the history across a rebuild as tpumd does.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.md.verlet import _remap_shear as j_remap
from tpumd.models.pair_gran import PairGranHookeHistory as JGran
from tpumd.models.pair_lj_cut import PairLJCut as JLJ
from tpumd.ops import neighbor as jnb
from tpumd.ops.pairwise import pair_sums as j_pair_sums
from tpumd_torch.interop import box_from_numpy, gran_from_numpy, \
    neighbor_config_from_numpy, neighbor_state_from_numpy, pair_from_numpy
from tpumd_torch.md.verlet import _remap_shear
from tpumd_torch.ops import gather as p1
from tpumd_torch.ops import neighbor as nb
from tpumd_torch.ops.pairwise import pair_sums

F64 = torch.float64
A_FCC = (4 / 0.8442) ** (1 / 3)       # in.lj's fcc lattice constant
BASIS = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
TILT = (1.2, 0.6, -0.8)


def _fcc(cells, seed, amp=0.05):
    """Perturbed fcc lamda coordinates (fractions of the box) of
    cells = (nx, ny, nz) unit cells, shuffled."""
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in cells],
                                indexing="ij"), -1).reshape(-1, 1, 3)
    lam = ((grid + BASIS[None]).reshape(-1, 3)) / np.asarray(cells)
    rng = np.random.default_rng(seed)
    lam = lam + rng.uniform(-amp, amp, lam.shape) / (A_FCC
                                                     * np.asarray(cells))
    return lam[rng.permutation(len(lam))]


def _system(case):
    """(x (N, 3), box mapping, extras) of a named case."""
    cells, periodic, tilt = (5, 5, 5), (True, True, True), None
    if case == "nonperiodic_z":
        periodic = (True, True, False)
    elif case == "small_box":
        cells = (2, 2, 2)
    elif case == "small_box_xy":
        cells = (2, 3, 4)
    elif case == "triclinic":
        tilt = TILT
    lam = _fcc(cells, seed=len(case))
    ell = A_FCC * np.asarray(cells)
    lam = lam % 1.0
    x = lam * ell
    if tilt is not None:
        x[:, 0] += tilt[0] * lam[:, 1] + tilt[1] * lam[:, 2]
        x[:, 1] += tilt[2] * lam[:, 2]
    box = {"lo": np.zeros(3), "hi": ell, "periodic": periodic}
    if tilt is not None:
        box["tilt"] = np.asarray(tilt)
    n = len(x)
    rng = np.random.default_rng(7)
    extra = {"tag": np.arange(1, n + 1, dtype=np.int32),
             "type": rng.integers(1, 3, n).astype(np.int32)}
    if case == "exclude":
        extra["gmask"] = (1 | 2 * rng.integers(0, 2, n)
                          | 4 * rng.integers(0, 2, n)).astype(np.int32)
        extra["exclude_bits"] = ((2, 4), (2, 2))
    if case in ("special", "small_box"):
        nspec = 4
        st = rng.integers(1, n + 1, (n, nspec)).astype(np.int32)
        st[rng.random((n, nspec)) < 0.25] = 0     # some empty entries
        extra["special_tags"] = st
        extra["special_codes"] = rng.integers(1, 4, (n, nspec)).astype(
            np.int32)
    return x, box, extra


def _jbox(box):
    if "tilt" in box:
        return JBox.triclinic(box["lo"], box["hi"], box["tilt"],
                              dtype=jnp.float64, periodic=box["periodic"])
    return JBox.orthogonal(box["lo"], box["hi"], dtype=jnp.float64,
                           periodic=box["periodic"])


def _both(case, cutneigh=2.8, **cfg_kw):
    """Each package's (x, box, cfg) of a case; the configs are compared."""
    x, box, extra = _system(case)
    jbox = _jbox(box)
    tbox = box_from_numpy(box, device="cpu", dtype=F64)
    special = "special_tags" in extra
    jcfg = jnb.choose_config(jbox, cutneigh, 0.3, len(x),
                             has_special=special, **cfg_kw)
    tcfg = nb.choose_config(tbox, cutneigh, 0.3, len(x),
                            has_special=special, **cfg_kw)
    excl = extra.get("exclude_bits", ())
    jcfg = dataclasses.replace(jcfg, exclude_bits=excl)
    tcfg = dataclasses.replace(tcfg, exclude_bits=excl)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert neighbor_config_from_numpy(dataclasses.asdict(jcfg)) == tcfg
    return x, extra, (jbox, jcfg), (tbox, tcfg)


@functools.lru_cache(maxsize=None)
def _build(case, **cfg_kw):
    """Both packages' lists of a case (built once per case and config)."""
    x, extra, (jbox, jcfg), (tbox, tcfg) = _both(case, **cfg_kw)
    jargs, targs = {}, {}
    for k in ("special_tags", "special_codes", "tag", "gmask"):
        if k in extra:
            jargs[k] = jnp.asarray(extra[k])
            targs[k] = torch.as_tensor(extra[k])
    jout = jnb.build_neighbors(jnp.asarray(x), jbox, jcfg, **jargs)
    n0 = p1.counts.plain_calls
    tout = nb.build_neighbors(torch.as_tensor(x), tbox, tcfg, **targs)
    # per block the cells and the coordinates, and the tags for sbits
    nblocks = -(-len(x) // tcfg.block)
    assert p1.counts.plain_calls - n0 == 2 * nblocks + ("special_tags"
                                                        in extra)
    return x, extra, (jbox, jcfg, jout), (tbox, tcfg, tout)


def _pairs(idx, sbits):
    """{(i, j): special code} of a list's non-padding slots."""
    out = {}
    for i, (row, code) in enumerate(zip(idx, sbits)):
        for j, c in zip(row.tolist(), code.tolist()):
            if j != i:
                assert (i, j) not in out, "a pair twice in one row"
                out[(i, j)] = c
    return out


CASES = ["periodic", "nonperiodic_z", "small_box", "small_box_xy",
         "triclinic", "exclude", "special"]


@pytest.mark.parametrize("case", CASES)
def test_build_neighbors_matches_tpumd(case):
    x, extra, (jbox, jcfg, jout), (tbox, tcfg, tout) = _build(case)
    jidx, jsb, jmc, jover = (np.asarray(a) for a in jout)
    tidx, tsb, tmc, tover = (a.numpy() for a in tout)
    assert tidx.shape == jidx.shape and tidx.dtype == np.int32
    assert bool(tover) == bool(jover) is False
    assert int(tmc) == int(jmc) > 0
    pairs = _pairs(tidx, tsb)
    assert pairs == _pairs(jidx, jsb)
    assert len(pairs) > 10 * len(x)
    if case.startswith("small_box"):
        assert tcfg.image_shifts[0] == (0, 0, 0)
        assert len(tcfg.image_shifts) == (27 if case == "small_box" else 9)
        assert tidx.max() >= len(x)          # image copies are neighbors
    if case in ("special", "small_box"):
        assert {1, 2, 3} <= set(pairs.values())
    if case == "exclude":
        g = extra["gmask"]
        for (i, j) in pairs:
            assert not ((g[i] & 2) and (g[j] & 2))
            assert not ((g[i] & 2) and (g[j] & 4) or (g[i] & 4)
                        and (g[j] & 2))


@pytest.mark.parametrize("what", ["kmax", "cell_cap"])
def test_overflow_flag_matches_tpumd(what):
    x, _, _, _ = _both("periodic")
    kw = {"kmax": 40} if what == "kmax" else {"cell_cap": 8}
    _, _, (_, _, jout), (_, _, tout) = _build("periodic", **kw)
    assert bool(tout[3]) == bool(jout[3]) is True
    if what == "kmax":
        assert int(tout[2]) == int(jout[2]) > 40


@pytest.mark.parametrize("case", ["periodic", "triclinic"])
def test_displacement_check_matches_tpumd(case):
    x, box, _ = _system(case)
    jbox = _jbox(box)
    tbox = box_from_numpy(box, device="cpu", dtype=F64)
    rng = np.random.default_rng(3)
    small = x + rng.uniform(-0.08, 0.08, x.shape)
    wrapped = small.copy()
    wrapped[0, 0] += box["hi"][0] - box["lo"][0]   # one box vector
    moved = small.copy()
    moved[5, 1] += 0.2
    for xn, want in ((small, False), (wrapped, False), (moved, True)):
        j = bool(jnb.displacement_exceeded(jnp.asarray(xn), jnp.asarray(x),
                                           jbox, 0.3))
        t = bool(nb.displacement_exceeded(torch.as_tensor(xn),
                                          torch.as_tensor(x), tbox, 0.3))
        assert t == j == want


def _lj_pairs():
    jp = JLJ(2)
    jp.mix = "arithmetic"
    jp.shift = True
    jp.coeff(1, 1, 1, 1, 1.0, 1.0, 2.5)
    jp.coeff(2, 2, 2, 2, 0.5, 1.2, 2.2)
    jp.init()
    tp = pair_from_numpy(jp.epsilon, jp.sigma, jp.cut, shift=True,
                         mix="arithmetic")
    return jp, tp


def _close(t, j, what, tol=1e-12):
    j = np.asarray(j)
    top = np.abs(j).max()
    err = np.abs(t.numpy() - j).max()
    assert err <= tol * top, f"{what}: {err} > {tol} * {top}"


@pytest.mark.parametrize("case", ["periodic", "nonperiodic_z",
                                  "small_box_xy", "triclinic", "special"])
def test_pair_sums_matches_tpumd(case):
    x, extra, (jbox, jcfg, jout), (tbox, tcfg, _) = _build(case)
    jp, tp = _lj_pairs()
    typ = extra["type"]
    idx, sbits = np.asarray(jout[0]), np.asarray(jout[1])
    special = (1.0, 0.0, 0.5, 0.8) if case == "special" else None
    jext = text = None
    if tcfg.image_shifts:
        ns = len(tcfg.image_shifts)
        jext = (jnb.ext_coords(jnp.asarray(x), jbox, jcfg),
                jnp.tile(jnp.asarray(typ), ns), None,
                jnb.ext_box(jbox, jcfg))
        tx = torch.as_tensor(x)
        text = (nb.ext_coords(tx, tbox, tcfg),
                torch.as_tensor(typ).repeat(ns), None,
                nb.ext_box(tbox, tcfg))
        _close(text[0], jext[0], "image copies", 0)
    # jitted: one compile instead of one per eager operation
    fj, ej, _, vj = jax.jit(lambda *a: j_pair_sums(
        *a[:2], jbox, *a[2:], jp.pair_fn,
        None if special is None else jnp.asarray(special), None, True,
        True, ext=jext))(jnp.asarray(x), jnp.asarray(typ),
                         jnp.asarray(idx), jnp.asarray(sbits))
    tn = neighbor_state_from_numpy(idx, sbits, x, device="cpu", dtype=F64)
    n0 = p1.counts.plain_calls
    ft, et, ect, vt = pair_sums(
        torch.as_tensor(x), torch.as_tensor(typ), tbox, tn.idx, tn.sbits,
        tp.pair_fn, special, None, True, True, ext=text)
    # the packed j rows, and the coefficients of each pair
    assert p1.counts.plain_calls - n0 == 2
    _close(ft, fj, "forces")
    _close(vt, vj, "virial")
    assert float(et) == pytest.approx(float(ej), rel=1e-12)
    assert float(ect) == 0.0
    assert float(et) < 0 and np.abs(np.asarray(fj)).max() > 1.0
    fo, eo, _, vo = pair_sums(
        torch.as_tensor(x), torch.as_tensor(typ), tbox, tn.idx, tn.sbits,
        tp.pair_fn, special, None, False, False, ext=text)
    assert eo is None and vo is None and torch.equal(fo, ft)


def _spheres(seed=11):
    """180 spheres of radius ~0.5 on a perturbed cubic lattice of spacing
    0.97 (each touching its neighbours), x and y periodic, z not; the
    bottom layer in group bit 2 (frozen), gmask bit 1 for all."""
    nx, ny, nz = 6, 6, 5
    a = 0.97
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                indexing="ij"), -1).reshape(-1, 3)
    x = (grid + 0.5) * a + rng.uniform(-0.01, 0.01, grid.shape)
    n = len(x)
    radius = rng.uniform(0.48, 0.52, n)
    box = {"lo": np.zeros(3), "hi": np.array([nx * a, ny * a, nz * a]),
           "periodic": (True, True, False)}
    s = {"x": x, "v": rng.normal(0, 0.5, (n, 3)),
         "omega": rng.normal(0, 0.5, (n, 3)), "radius": radius,
         "rmass": 4 / 3 * np.pi * radius ** 3,
         "gmask": (1 | 2 * (grid[:, 2] == 0)).astype(np.int32)}
    return s, box


def _ns(arrays, box, conv):
    return types.SimpleNamespace(box=box, **{k: conv(v)
                                             for k, v in arrays.items()})


@pytest.mark.parametrize("damping", ["deck", "limit_damping"])
def test_compute_gran_matches_tpumd(damping):
    arrs, box = _spheres()
    jbox = _jbox(box)
    tbox = box_from_numpy(box, device="cpu", dtype=F64)
    cutneigh = 2 * arrs["radius"].max() + 0.1
    jcfg = dataclasses.replace(
        jnb.choose_config(jbox, cutneigh, 0.1, len(arrs["x"])),
        exclude_bits=((2, 2),))
    idx, _, _, over = jnb.build_neighbors(jnp.asarray(arrs["x"]), jbox, jcfg,
                                          gmask=jnp.asarray(arrs["gmask"]))
    assert not bool(over)
    jg = JGran(1)
    extra = ("limit_damping",) if damping == "limit_damping" else ()
    gammat = "NULL" if damping == "limit_damping" else "0.0"
    jg.settings(2000.0, "NULL", 50.0, gammat, 0.5,
                1 if damping == "limit_damping" else 0, *extra)
    jg.freeze_group_bit = 2
    tg = gran_from_numpy(jg.kn, jg.kt, jg.gamman, jg.gammat, jg.xmu,
                         limit_damping=jg.limit_damping, freeze_bit=2)
    ts = _ns(arrs, tbox, torch.as_tensor)
    jgran = jax.jit(lambda a, i, sh, su: jg.compute_gran(
        _ns(a, jbox, jnp.asarray), i, sh, 1e-4, su), static_argnums=3)
    jarrs = {k: jnp.asarray(v) for k, v in arrs.items()}
    idx = np.asarray(idx)
    rng = np.random.default_rng(5)
    shear0 = rng.normal(0, 1e-3, idx.shape + (3,))
    for scale in (1.0, 40.0):
        for su in (True, False):
            jf, jt, jsh = jgran(jarrs, jnp.asarray(idx),
                                jnp.asarray(shear0 * scale), su)
            tn = neighbor_state_from_numpy(
                idx, np.zeros_like(idx), arrs["x"], shear=shear0 * scale,
                device="cpu", dtype=F64)
            n0 = p1.counts.plain_calls
            tf, tt, tsh = tg.compute_gran(ts, tn.idx, tn.shear, 1e-4, su)
            assert p1.counts.plain_calls - n0 == 1
            what = f"scale {scale} shearupdate {su}"
            _close(tf, jf, "force " + what)
            _close(tt, jt, "torque " + what)
            if su:
                _close(tsh, jsh, "shear " + what)
            else:
                assert tsh is tn.shear
    touching = np.asarray(jsh).any(-1)
    assert touching.sum() > 2 * len(idx)


def test_remap_shear_matches_tpumd():
    arrs, box = _spheres()
    jbox = _jbox(box)
    cutneigh = 2 * arrs["radius"].max() + 0.1
    jcfg = jnb.choose_config(jbox, cutneigh, 0.1, len(arrs["x"]))
    rng = np.random.default_rng(9)
    x1 = arrs["x"] + rng.uniform(-0.04, 0.04, arrs["x"].shape)
    old = np.asarray(jnb.build_neighbors(jnp.asarray(arrs["x"]), jbox,
                                         jcfg)[0])
    new = np.asarray(jnb.build_neighbors(jnp.asarray(x1), jbox, jcfg)[0])
    shear = rng.normal(0, 1.0, old.shape + (3,))
    want = np.asarray(j_remap(jnp.asarray(old), jnp.asarray(new),
                              jnp.asarray(shear)))
    got = _remap_shear(torch.as_tensor(old), torch.as_tensor(new),
                       torch.as_tensor(shear)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any(-1).sum() > len(old)
