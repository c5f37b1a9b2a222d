"""gran/hooke/history over the cell grid's pair list, on the CPU.

Small generated chute packs (``bench_targets.chute_data``: layers of
spheres of diameter 1 over a frozen base, ``boundary p p fs``, the
base-base pairs excluded) after 30 steps of the chute deck on the port:

* "9x5x4": 10x6x8 spheres, every axis of 3 cells or more, z non-periodic;
* "5x2x3": 6x3x6 spheres, y periodic with 2 cells (the +-1 neighbours are
  one cell at two images);
* "5x5x2": 6x6x4 spheres, z non-periodic with 2 cells (the offsets alias,
  so only -1 and 0 are visited).

* The plain build's rows are exactly numpy's pairs within cutneigh, in
  stencil order (z, y, x offsets as ``cellgrid._offs`` gives them, then
  slot), padded with the own slot, with no base-base pair; the run's own
  list equals the plain build on the positions it was built from.
* The plain list sweep equals the stencil oracle ``gran_compact_sums``
  (f64: forces, torques and shear to 1e-12 of their largest, history tags
  equal) on a cluster where one sphere has 14 contacts (more than KH),
  with and without history, and at every step of 20 steps of the deck
  that cross rebuilds, where the run also takes only the list path: one
  plain build per grid set-up and rebuild, one list sweep per force
  evaluation, no stencil sweep.
* The box's shrink-wrapped z face moves only at a rebuild, so the box a
  carried list was built under is the box of every step until the next
  rebuild: the rebuild check takes no box term (the state carries no box
  corners, no fix moving the box) and triggers at the half skin.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

from tpumd_torch.bench_targets import IN_CHUTE, chute_data
from tpumd_torch.core.state import Box
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_gran as cgg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import gran_cellgrid as b6
from tpumd_torch.ops.cellgrid_gran import KH, GranCoeffs
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

SYSTEMS = {"9x5x4": (10, 6, 8), "5x2x3": (6, 3, 6), "5x5x2": (6, 6, 4)}
DT = 1e-4
KN = 2000.0


def _script(dims, thermo=100):
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/data.chute"
        chute_data(path, *dims)
        script = LammpsScript(device="cpu", dtype=torch.float64)
        script.run_string(IN_CHUTE.format(data=path).replace(
            "thermo          100", f"thermo          {thermo}"))
    script.sim.verbose = False
    return script


@functools.lru_cache(maxsize=None)
def _system(name):
    """The chute pack's simulation after 30 steps."""
    script = _script(SYSTEMS[name])
    script.run_string("run 30")
    return script.sim


def _stencil_rows(x, valid, gmask, box, cfg, exclude_bits):
    """numpy: each slot's valid partners within cutneigh that no group-bit
    pair excludes, in stencil order, d = x_i - (x_j + the cell's wrap)."""
    x, valid, gmask = x.numpy(), valid.numpy(), gmask.numpy()
    L = box.lengths.numpy()
    dims = (cfg.nx, cfg.ny, cfg.nz)
    offs = [cg._offs(n, p) for n, p in zip(dims, box.periodic)]
    rows = []
    for i in range(cfg.capacity):
        row = []
        rows.append(row)
        if not valid[i]:
            continue
        cell = i // cfg.cap
        c = (cell % cfg.nx, cell // cfg.nx % cfg.ny, cell // (cfg.nx * cfg.ny))
        for oz in offs[2]:
            for oy in offs[1]:
                for ox in offs[0]:
                    jc, shift = [], np.zeros(3)
                    for a, o in enumerate((ox, oy, oz)):
                        j = c[a] + o
                        if j >= dims[a]:
                            j -= dims[a]
                            shift[a] = L[a] if box.periodic[a] else 0.0
                        elif j < 0:
                            j += dims[a]
                            shift[a] = -L[a] if box.periodic[a] else 0.0
                        jc.append(j)
                    jcell = (jc[2] * cfg.ny + jc[1]) * cfg.nx + jc[0]
                    js = np.arange(jcell * cfg.cap, (jcell + 1) * cfg.cap)
                    d = x[i] - (x[js] + shift)
                    r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] \
                        + d[:, 2] * d[:, 2]
                    ok = valid[js] & (r2 < cfg.cutneigh ** 2)
                    if (ox, oy, oz) == (0, 0, 0):
                        ok &= js != i
                    for b1, b2 in exclude_bits:
                        gi, gj = gmask[i], gmask[js]
                        ok &= ~((((gi & b1) > 0) & ((gj & b2) > 0))
                                | (((gi & b2) > 0) & ((gj & b1) > 0)))
                    row += js[ok].tolist()
    return rows


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_plain_build_rows_are_the_stencil_pairs_within_cutneigh(name):
    sim = _system(name)
    s, neigh, _ = sim._carry
    cfg, excl = sim._neigh_cfg, sim._ctx.pairlist_exclude
    assert f"{cfg.nx}x{cfg.ny}x{cfg.nz}" == name
    assert s.box.periodic == (True, True, False) and excl == ((2, 2),)
    assert cfg.cutneigh == pytest.approx(1.1)
    # the run's list was built from the positions of its last re-bin,
    # under the box of this step (the z face moves only at a rebuild), so
    # the state carries no box corners for the rebuild check
    assert neigh.lohold is None and neigh.hihold is None
    K = sim._ctx.pairlist_k
    args = (neigh.xhold, neigh.valid, s.tag, None, None, s.box, cfg, K,
            s.gmask)
    pairs, npairs, longest, over = bpl.cellgrid_pairlist_plain(*args, excl)
    assert not bool(over) and int(longest) == int(npairs.max())
    assert torch.equal(pairs, neigh.pairs)
    assert torch.equal(npairs, neigh.npairs)
    rows = _stencil_rows(neigh.xhold, neigh.valid, s.gmask, s.box, cfg,
                         excl)
    j, code = (a.numpy() for a in bpl.unpack(pairs))
    assert (code == 0).all()
    for i, row in enumerate(rows):
        n = int(npairs[i])
        assert n == len(row)
        assert j[i, :n].tolist() == row
        assert (j[i, n:] == i).all()
    # no base-base pair is in the list, though the base has such pairs
    g = s.gmask.numpy()
    live = np.arange(K)[None, :] < npairs.numpy()[:, None]
    base = (g[:, None] & 2) > 0
    assert not (live & base & ((g[j] & 2) > 0)).any()
    full = bpl.cellgrid_pairlist_plain(*args)
    assert int(full[1].sum()) > int(npairs.sum())


def _cluster():
    """A sphere with 14 touching neighbours (more than KH) on a 5^3 grid
    of a p p f box, and a few spheres elsewhere; (args of the sweeps,
    planes, coefficients, the list, the centre's slot)."""
    rng = np.random.default_rng(11)
    k = np.arange(14) + 0.5
    polar, azim = np.arccos(1 - 2 * k / 14), np.pi * (1 + 5 ** 0.5) * k
    shell = 0.93 * np.stack([np.cos(azim) * np.sin(polar),
                             np.sin(azim) * np.sin(polar), np.cos(polar)], 1)
    x = np.concatenate([[[3.0, 3.0, 3.0]], 3.0 + shell,
                        rng.uniform(0.3, 1.2, (4, 3))])
    n = len(x)
    box = Box.orthogonal(np.zeros(3), np.full(3, 6.0), device="cpu",
                         dtype=torch.float64, periodic=(True, True, False))
    cfg = cg.choose_cellgrid_config(box, 1.1, 0.1, n, cap=16)
    xp = cg.pad_rows(torch.as_tensor(x), cfg.capacity)
    valid0 = torch.arange(cfg.capacity) < n
    perm, valid, _, over = cg.bin_permutation(xp, valid0, box, cfg)
    assert not bool(over)
    idx = torch.clamp(perm, min=0)

    def place(a, fill=0):
        a = cg.pad_rows(torch.as_tensor(a), cfg.capacity)[idx]
        keep = valid.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(keep, a, torch.full_like(a, fill))
    tag = place(np.arange(1, n + 1, dtype=np.int32))
    gmask = place(np.where(np.arange(n) >= 15, 3, 1).astype(np.int32))
    planes = (place(rng.normal(0, 1, (n, 3))),
              place(rng.normal(0, 5, (n, 3))), place(np.full(n, 0.5)),
              place(rng.uniform(0.5, 1.5, n), fill=1.0), gmask)
    c = GranCoeffs(KN, KN * 2 / 7, 50.0, 25.0, 0.5, True, 2, ((2, 2),))
    x = place(x)
    plist = bpl.cellgrid_pairlist_plain(x, valid, tag, None, None, box, cfg,
                                        32, gmask, c.exclude_bits)
    assert not bool(plist[3])
    centre = int(torch.nonzero(tag == 1)[0])
    return x, tag, valid, box, cfg, planes, c, plist[:2], centre


def _assert_same(out, ref):
    """Forces, torques and shear to 1e-12 of their largest (equal where
    all are 0), history tags equal."""
    for a, b in zip(out[:2] + out[3:], ref[:2] + ref[3:]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale
    assert float(out[0].abs().max()) > 0
    assert torch.equal(out[2], ref[2])


def test_plain_list_sweep_with_more_contacts_than_kh():
    x, tag, valid, box, cfg, planes, c, (pairs, npairs), centre = _cluster()
    np_ = cfg.capacity
    stags = torch.zeros((np_, KH), dtype=torch.int32)
    shear = torch.zeros((np_, KH, 3), dtype=torch.float64)
    d = x[centre] - x
    touching = ((d * d).sum(1) < 1.0) & valid
    assert int(touching.sum()) - 1 == 14 > KH
    for step in range(3):
        for shearupdate in (False, True):
            args = (x, tag, valid, stags, shear, box, cfg, c, planes, DT,
                    shearupdate)
            out = cgg.gran_pairlist_plain(x, tag, stags, shear, box, c,
                                          planes, DT, shearupdate, pairs,
                                          npairs)
            _assert_same(out, cgg.gran_compact_sums(*args))
        # the centre's first KH contacts keep their history, the rest
        # lose it; the next sweep reads it back, scaled so most slip
        assert int((out[2][centre] != 0).sum()) == KH
        stags, shear = out[2], out[3] * 40.0
        x = x + 1e-3 * planes[0]


def test_list_path_over_20_steps_across_rebuilds(monkeypatch):
    """At each of steps 20-40 of the 480-sphere deck (a rebuild at step
    30) the list sweep of the step's state and history equals the
    stencil oracle, and the run itself sweeps only lists."""
    calls = []

    def stencil(*a, **k):
        calls.append(1)
        return cgg.gran_compact_sums(*a, **k)
    monkeypatch.setattr(b6, "gran_compact_sums", stencil)
    script = _script(SYSTEMS["9x5x4"])
    script.run_string("run 20")
    sim = script.sim
    for c in (b6.counts, bpl.counts):
        c.reset()
    setups0, builds0 = sim.grid_setups, int(sim._carry[1].nbuilds)
    for step in range(20):
        s, neigh, _ = sim._carry
        c = sim.pair.kernel_coeffs()
        planes = (s.v, s.omega, s.radius,
                  torch.where(s.rmass > 0, s.rmass, 1.0), s.gmask)
        out = b6.gran_cellgrid(s.x, s.tag, neigh.valid, neigh.shear_tags,
                               neigh.shear, s.box, sim._neigh_cfg, c,
                               planes, DT, True,
                               (neigh.pairs, neigh.npairs, neigh.row2slot))
        ref = cgg.gran_compact_sums(s.x, s.tag, neigh.valid,
                                    neigh.shear_tags, neigh.shear, s.box,
                                    sim._neigh_cfg, c, planes, DT, True)
        _assert_same(out, ref)
        script.run_string("run 1")
    rebuilds = int(sim._carry[1].nbuilds) - builds0
    assert rebuilds >= 1 and sim.grid_setups == setups0
    # per run of 1 step one in-step and one thermo sweep, and the test's
    assert b6.counts.plain_calls == 20 * 3
    assert bpl.counts.plain_calls == rebuilds
    assert b6.counts.kernel_launches == 0 and not calls


def test_shrink_wrap_moves_the_box_only_at_a_rebuild():
    """chute's z face is shrink-wrapped at each rebuild and nowhere else:
    between rebuilds the box is the one the carried list was built under,
    so the rebuild check needs no box term (the state carries no box
    corners, as no fix moves the box) and its trigger is the half skin;
    at a rebuild the new list takes the new box."""
    script = _script(SYSTEMS["9x5x4"])
    script.run_string("run 20")
    sim = script.sim
    assert not any(fx.box_change for fx in sim._ctx.fixes)
    built = sim._carry[0].box
    moved = 0
    for _ in range(20):
        hi0 = sim._carry[0].box.hi.clone()
        script.run_string("run 1")
        s, neigh, _ = sim._carry
        assert neigh.lohold is None and neigh.hihold is None
        if neigh.ago == 0:
            moved += not torch.equal(s.box.hi, hi0)
            built = s.box
        else:
            assert torch.equal(s.box.hi, hi0)
            assert torch.equal(s.box.lo, built.lo)
            assert torch.equal(s.box.hi, built.hi)
            skin = sim._neigh_cfg.skin
            d = (s.x - neigh.xhold)[neigh.valid]
            # the trigger is the half skin's
            assert bool(cg.displacement_exceeded(
                s.x, neigh.xhold, neigh.valid, s.box, skin)) == bool(
                (d * d).sum(1).max() > (0.5 * skin) ** 2)
    assert moved >= 1
