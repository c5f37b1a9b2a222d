"""The gran/hooke/history cell-grid kernel module of the port against tpumd.

On the CPU the wrapper ``gran_cellgrid`` runs its plain PyTorch version,
the sweep of the grid's pair list (built here by the plain build at the
grid's cutneigh with the coefficient set's exclusions dropped); these
tests hold it against tpumd on the grid-ordered state of small
generated chute packs (``bench_targets.chute_data``: layers of spheres of
diameter 1 over a frozen base, z non-periodic and shrink-wrapped) after 30
steps of the chute deck on the port, so the contact history is live:

* "9x5x4": 10x6x8 spheres, every axis of 3 cells or more;
* "5x2x3": 6x3x6 spheres, y periodic with 2 cells (the +-1 neighbours are
  one cell at two images);
* "5x5x2": 6x6x4 spheres, z non-periodic with 2 cells (the offsets alias,
  so only -1 and 0 are visited).

Coefficient sets: the deck's (dampflag 0, the frozen base's bit, the
base-base exclusion), dampflag 1 with no group bits, and dampflag 1 with
both bits and limit_damping.  The history is fed as it is and scaled by 40,
which makes most contacts slip (the Coulomb rescale of force and shear).

* f64: the plain version against tpumd's ``gran_compact_sums``: forces,
  torques and shear to 1e-12 of their largest, equal contact tags, for
  both ``shearupdate`` values.
* f32: the plain version against the TPU kernel
  ``gran_cellgrid_forces_pallas`` under ``pltpu.force_tpu_interpret_mode()``
  (shearupdate only; it needs nz >= 3): forces and torques to 5e-5 of
  their largest, equal tags, shear to 1e-6.

The CUDA kernel against the plain version, on the card, is in
tests/test_torch_cuda_kernels.py, which imports no JAX.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpumd.core.state import Box as JBox
from tpumd.ops import cellgrid as jcg
from tpumd.ops.cellgrid_gran import gran_compact_sums as j_sums
from tpumd.ops.pallas_gran import gran_cellgrid_forces_pallas
from tpumd_torch.bench_targets import IN_CHUTE, chute_data
from tpumd_torch.core.state import Box
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import gran_cellgrid as b6
from tpumd_torch.ops.cellgrid_gran import GranCoeffs
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

SYSTEMS = {"9x5x4": (10, 6, 8), "5x2x3": (6, 3, 6), "5x5x2": (6, 6, 4)}
DT = 1e-4
KN = 2000.0


def _coeffs(which, freeze_bit, excl):
    """(GranCoeffs, tpumd params) of a coefficient set."""
    kt, gamman = KN * 2.0 / 7.0, 50.0
    if which == "deck":
        c = GranCoeffs(KN, kt, gamman, 0.0, 0.5, False, freeze_bit, excl)
    elif which == "damp":
        c = GranCoeffs(KN, kt, gamman, 25.0, 0.5, False, 0, ())
    else:
        c = GranCoeffs(KN, kt, gamman, 25.0, 0.5, True, freeze_bit, excl)
    params = dict(kn=c.kn, kt=c.kt, gamman=c.gamman, gammat=c.gammat,
                  xmu=c.xmu, limit_damping=c.limit_damping,
                  freeze_bit=c.freeze_bit, exclude_bits=c.exclude_bits)
    return c, params


@functools.lru_cache(maxsize=None)
def _system(name):
    """The grid-ordered f64 state, validity, history, box, grid, freeze
    bit and exclusions of a small chute pack after 30 steps."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/data.chute"
        chute_data(path, *SYSTEMS[name])
        script = LammpsScript(device="cpu", dtype=torch.float64)
        script.run_string(IN_CHUTE.format(data=path))
        script.sim.verbose = False
        script.run_string("run 30")
    sim = script.sim
    s, neigh, _ = sim._carry
    return (s, neigh, sim._neigh_cfg, sim.pair.freeze_group_bit,
            sim.pair.exclude_bits)


def _inputs(name, dtype, scale):
    s, neigh, cfg, fbit, excl = _system(name)
    f = (lambda a: a.to(dtype))
    planes = (f(s.v), f(s.omega), f(s.radius),
              f(torch.where(s.rmass > 0, s.rmass, 1.0)), s.gmask)
    box = Box(lo=f(s.box.lo), hi=f(s.box.hi), periodic=s.box.periodic)
    return (f(s.x), s.tag, neigh.valid, neigh.shear_tags,
            f(neigh.shear * scale), box, cfg), planes, fbit, excl


def _plist(name, c):
    """(pairs, npairs, rows) of the system's grid at cutneigh, built from
    its f64 positions with c's exclusions dropped."""
    s, neigh, cfg, _, _ = _system(name)
    natoms = int(neigh.valid.sum())
    pairs, npairs, _, over = bpl.cellgrid_pairlist_plain(
        s.x, neigh.valid, s.tag, None, None, s.box, cfg,
        cg.pairlist_kmax(s.box, cfg.cutneigh, natoms) + 16, s.gmask,
        c.exclude_bits)
    assert not bool(over)
    return pairs, npairs, cg.row2slot_from_tags(s.tag, natoms)


def _jax(args, planes, dtype):
    x, tag, valid, stags, shear, box, cfg = args
    v, om, rad, rm, gm = planes
    jbox = JBox.orthogonal(box.lo.numpy(), box.hi.numpy(), dtype=dtype,
                           periodic=box.periodic)
    jcfg = jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    a = (lambda t: jnp.asarray(t.numpy()))
    jplanes = (a(v[:, 0]), a(v[:, 1]), a(v[:, 2]), a(om[:, 0]), a(om[:, 1]),
               a(om[:, 2]), a(rad), a(rm), a(gm).astype(dtype))
    return (a(x), a(tag), a(valid), a(stags), a(shear), jbox, jcfg), jplanes


def _assert_close(got, ref, tol):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * scale)


def test_systems_have_live_history():
    """Each system's grid is as named, its history is live after 30 steps,
    and the base's bit and exclusion are those of the deck."""
    for name in SYSTEMS:
        s, neigh, cfg, fbit, excl = _system(name)
        assert f"{cfg.nx}x{cfg.ny}x{cfg.nz}" == name
        assert s.box.periodic == (True, True, False)
        assert fbit == 2 and excl == ((2, 2),)
        live = (neigh.shear_tags != 0).sum(1)
        assert int(live.max()) <= 8
        assert int(live.sum()) > 3 * int(s.tag.gt(0).sum())


@pytest.mark.parametrize("scale", [1.0, 40.0])
@pytest.mark.parametrize("which", ["deck", "damp", "limit"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_f64_plain_matches_gran_compact_sums(name, which, scale):
    args, planes, fbit, excl = _inputs(name, torch.float64, scale)
    c, params = _coeffs(which, fbit, excl)
    jargs, jplanes = _jax(args, planes, jnp.float64)
    slips = 0
    for shearupdate in (True, False):
        n0 = b6.counts.plain_calls
        f, tq, stags, shear = b6.gran_cellgrid(*args, c, planes, DT,
                                             shearupdate, _plist(name, c))
        assert b6.counts.plain_calls == n0 + 1
        fj, tqj, stj, shj = j_sums(*jargs, params, jplanes, DT, shearupdate)
        _assert_close(f, fj, 1e-12)
        _assert_close(tq, tqj, 1e-12)
        np.testing.assert_array_equal(stags.numpy(), np.asarray(stj))
        _assert_close(shear, shj, 1e-12)
        if not shearupdate:
            assert stags is args[3] and shear is args[4]
        else:
            # contacts that slipped come back rescaled
            slips = int((shear.norm(dim=-1) < 0.5 * args[4].norm(dim=-1))
                        .sum())
    assert slips > 0 or scale == 1.0


@pytest.mark.parametrize("which", ["deck", "damp"])
@pytest.mark.parametrize("name", ["9x5x4", "5x2x3"])
def test_f32_plain_matches_pallas_kernel(name, which):
    args, planes, fbit, excl = _inputs(name, torch.float32, 40.0)
    c, _ = _coeffs(which, fbit, excl)
    f, tq, stags, shear = b6.gran_cellgrid(*args, c, planes, DT, True,
                                         _plist(name, c))
    jargs, jplanes = _jax(args, planes, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        fj, tqj, stj, shj = gran_cellgrid_forces_pallas(
            *jargs, tuple(c), DT, jplanes)
    _assert_close(f, fj, 5e-5)
    _assert_close(tq, tqj, 5e-5)
    np.testing.assert_array_equal(stags.numpy(), np.asarray(stj))
    np.testing.assert_allclose(shear.numpy(), np.asarray(shj), rtol=0,
                               atol=1e-6)


def test_unported_cases_raise():
    """A CUDA-less device raises, group bits need the gmask, and the
    sweep needs a list."""
    args, planes, fbit, excl = _inputs("9x5x4", torch.float64, 1.0)
    c, _ = _coeffs("deck", fbit, excl)
    x, tag, valid, stags, shear, box, cfg = args
    plist = _plist("9x5x4", c)
    with pytest.raises(ValueError, match="gmask"):
        b6.gran_cellgrid(x, tag, valid, stags, shear, box, cfg, c,
                         planes[:4] + (None,), DT, True, plist)
    with pytest.raises(ValueError, match="no kernel"):
        b6.gran_cellgrid(x.to("meta"), tag, valid, stags, shear, box, cfg,
                         c, planes, DT, True, plist)
    with pytest.raises(ValueError, match="no pair list"):
        b6.gran_cellgrid(x, tag, valid, stags, shear, box, cfg, c, planes,
                         DT, True, (None, None, None))
