"""The cell grid's pair list (ops/cellgrid_pairlist.py) and the
lj/charmm/coul/long sweep over it, on the CPU.

Two systems: the 216-atom synthetic charged system of
tests/test_torch_charmm_kernel.py (a 3^3 grid of cap 16, special lists of
width 4 with codes 1-3) and LAMMPS's 2,004-atom solvated peptide with the
rhodo_class settings after set-up (a 2^3 grid of cap 368, S = 18, every
neighbour cell met at two images).

* The plain build's rows are, as sets, exactly the pairs of valid slots
  within cutneigh (numpy, all pairs at the minimum image, f64), in
  stencil order, padded with the row's own slot; each entry's code equals
  what tpumd's ``cellgrid_pair_sums`` special matching gives that pair on
  the same grid (its forces and pair count under weights that tell the
  codes apart, to 1e-12).
* A K too small sets the overflow flag; a run forced to it, at set-up or
  within a segment, grows K and prints the rows of an unforced run.
* The plain list sweep equals the stencil oracle (f64, 1e-12 of max|f|,
  every flag combination) on the set-up's list and after steps without a
  rebuild (the dynamics of the deck, then random moves of up to 0.45
  skin from the list's positions): no pair in range is missing.
* The rebuild check shrinks by the box's move since the build: an image
  pair that a box move and two moves under half the skin bring into force
  range is missing from the list, the half-skin check alone lets it
  through, the check with the box's move calls for a rebuild, and moves
  inside that shrunken trigger keep the sweep equal to the oracle.
* On the main path: one plain build per grid set-up and rebuild, one
  plain sweep per force evaluation; without a list the sweep raises.
* Garbage in the rows' tails past npairs (unspecified in the card's
  list) leaves the sweep's sums as they were, bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_charmm_kernel import _jax_inputs, _pairs, _system
from tpumd.ops import cellgrid as jcg
from tpumd_torch.bench_targets import IN_RHODO_CLASS
from tpumd_torch.md.verlet import decide_rebuild, grid_pairlist
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import charmm_cellgrid as b5
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "peptide")
FLAGS = ((1, 1), (0, 0), (1, 0), (0, 1))
# weights 1 + H[code] that tell the codes apart in a sum over pairs
H = (0.0, 1.0, 1e3, 1e6)


def _deck(thermo=5):
    return (IN_RHODO_CLASS.format(golden=GOLDEN).replace(
        "replicate       2 2 4\n", "") + f"thermo          {thermo}\n")


def _peptide(thermo=5):
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(_deck(thermo))
    script.sim.verbose = False
    return script


def _synthetic():
    """(state, valid, box, cfg, K sized from the density, coeffs)."""
    s, valid, box, cfg = _system(torch.float64)
    return (s, valid, box, cfg,
            cg.pairlist_kmax(box, cfg.cutneigh, int(valid.sum())),
            _pairs(torch.float64)[2])


def _set_up_peptide():
    script = _peptide()
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    c = sim.pair.kernel_coeffs(s.x, *sim._special_weights())
    return sim, s, neigh, c


def _system_of(which):
    """(state, valid, box, cfg, K, coeffs, list or None) of a system."""
    if which == "synthetic":
        return _synthetic() + (None,)
    sim, s, neigh, c = _set_up_peptide()
    # the list's own positions (SHAKE moved the atoms after the build)
    return (s.replace(x=neigh.xhold), neigh.valid, s.box, sim._neigh_cfg,
            sim._ctx.pairlist_k, c, (neigh.pairs, neigh.npairs))


def _rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


def _cell_xyz(cell, cfg):
    """(..., 3) x, y, z cell indices of linear cell ids."""
    return np.stack([cell % cfg.nx, cell // cfg.nx % cfg.ny,
                     cell // (cfg.nx * cfg.ny)], -1)


def _min_image(d, L):
    return d - L * np.round(d / L)


@pytest.mark.parametrize("which", ["synthetic", "peptide"])
def test_plain_build_rows_are_the_pairs_within_cutneigh(which):
    s, valid, box, cfg, kmax, c, built = _system_of(which)
    pairs, npairs, longest, over = bpl.cellgrid_pairlist_plain(
        s.x, valid, s.tag, s.special_tags, s.special_codes, box, cfg, kmax)
    assert not bool(over) and int(longest) == int(npairs.max())
    if built is not None:          # the set-up built the same list
        assert torch.equal(pairs, built[0]) and torch.equal(npairs,
                                                            built[1])
    x = s.x.numpy()
    L = box.lengths.numpy()
    v = valid.numpy()
    d = _min_image(x[:, None, :] - x[None, :, :], L)
    within = ((d * d).sum(-1) < cfg.cutneigh ** 2) & v[:, None] & v[None, :]
    np.fill_diagonal(within, False)
    j, code = (a.numpy() for a in bpl.unpack(pairs))
    k = np.arange(kmax)
    for i in range(cfg.capacity):
        n = int(npairs[i])
        assert n == within[i].sum()
        assert sorted(j[i, :n]) == list(np.nonzero(within[i])[0])
        assert (j[i, n:] == i).all() and (code[i, n:] == 0).all()
    # stencil order: rows visit the 27 cells in (z, y, x) offset order
    if min(cfg.nx, cfg.ny, cfg.nz) >= 3:
        n3 = np.array([cfg.nx, cfg.ny, cfg.nz])
        own = _cell_xyz(np.arange(cfg.capacity)[:, None] // cfg.cap, cfg)
        off = (_cell_xyz(j // cfg.cap, cfg) - own + 1) % n3
        rank = ((off[..., 2] * 3 + off[..., 1]) * 3 + off[..., 0]) * cfg.cap \
            + j % cfg.cap
        live = k[None, :] < npairs.numpy()[:, None]
        step = np.where(live[:, 1:], np.diff(rank, axis=1), 1)
        assert (step > 0).all()
    assert (code >= 0).all() and (code <= 3).all()
    assert (code[k[None, :] < npairs.numpy()[:, None]] > 0).any()

    # the codes against tpumd's special matching on the same grid: each
    # pair within cutneigh weighs 1 + H[code]
    wl = [np.asarray([1.0 + h for h in H])[s.special_codes.numpy()]] * 2
    xj, q, t, tag, vj, st, _, _, jbox, jcfg = _jax_inputs(
        s, valid, box, cfg, jnp.float64)
    cutsq = cfg.cutneigh ** 2

    def count(r2, ti, tj, w_lj, w_coul, qi, qj):
        inside = (r2 < cutsq).astype(r2.dtype)
        return w_lj * inside, w_lj * inside, inside, None
    fj, ej, nj, _ = jcg.cellgrid_pair_sums(
        xj, t, vj, jbox, jcfg, None, True, False,
        special=(tag, st, jnp.asarray(wl[0]), jnp.asarray(wl[1])), q=q,
        pair_fn_ex=count)
    mask = j != np.arange(cfg.capacity)[:, None]
    w = np.where(mask, 1.0 + np.asarray(H)[code], 0.0)
    dl = _min_image(x[:, None, :] - x[j], L)
    f = (dl * w[..., None]).sum(1)
    fj = np.asarray(fj)
    np.testing.assert_allclose(f, fj, rtol=0, atol=1e-12 * np.abs(fj).max())
    assert 2 * float(nj) == mask.sum()
    assert 2 * float(ej) == pytest.approx(w.sum(), rel=1e-15)


@pytest.mark.parametrize("where", ["setup", "segment"])
def test_a_list_too_short_regrows_and_runs_as_unforced(where):
    ref = _peptide()
    ref.run_string("run 0")
    ref.run_string("run 10")
    forced = _peptide()
    sim = forced.sim
    if where == "setup":
        sim._kmax_override = 64
        forced.run_string("run 0")
    else:
        forced.run_string("run 0")
        sim._kmax_override = 64
        sim._ctx = sim._make_ctx()
        s, neigh, fstates = sim._carry
        plist, over = grid_pairlist(s, neigh.valid, sim._ctx)
        assert bool(over) and int(plist["max_pairs"]) > 64
        sim._carry = (s, neigh.replace(overflow=neigh.overflow | over,
                                       **plist), fstates)
    forced.run_string("run 10")
    cfg, kmax = sim._neigh_cfg, sim._ctx.pairlist_k
    neigh = sim._carry[1]
    assert not bool(neigh.overflow)
    assert kmax > int(neigh.max_pairs) > 64
    assert cfg.cap == ref.sim._neigh_cfg.cap
    assert _rows(sim) == _rows(ref.sim)
    assert tuple(neigh.pairs.shape) == (cfg.capacity, kmax)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("which", ["synthetic", "peptide"])
def test_list_sweep_equals_stencil_oracle(which, flags):
    s, valid, box, cfg, kmax, c, built = _system_of(which)
    if built is None:
        built = bpl.cellgrid_pairlist(s.x, valid, s.tag, s.special_tags,
                                      s.special_codes, box, cfg, kmax)[:2]
    out = b5.charmm_cellgrid(s.x, s.q, s.type, *built, box, cfg, c, *flags)
    ref = b5.charmm_cellgrid_plain(s.x, s.q, s.type, valid, s.tag,
                                   s.special_tags, s.special_codes, box, cfg,
                                   c, *flags)
    _close(out, ref)


@pytest.mark.parametrize("which", ["synthetic", "peptide"])
def test_list_sweep_reads_no_entry_past_a_rows_count(which):
    """A row's tail past npairs is unspecified in the card's list: the
    plain sweep gives the same sums with garbage there."""
    s, valid, box, cfg, kmax, c, built = _system_of(which)
    if built is None:
        built = bpl.cellgrid_pairlist(s.x, valid, s.tag, s.special_tags,
                                      s.special_codes, box, cfg, kmax)[:2]
    pairs, npairs = built
    junk = pairs.clone()
    tail = torch.arange(kmax)[None, :] >= npairs[:, None].long()
    assert int(tail.sum()) > 0
    junk[tail] = torch.as_tensor(np.random.default_rng(5).integers(
        -2**31, 2**31 - 1, int(tail.sum())), dtype=torch.int32)
    _close(b5.charmm_cellgrid(s.x, s.q, s.type, junk, npairs, box, cfg, c,
                              1, 1),
           b5.charmm_cellgrid(s.x, s.q, s.type, pairs, npairs, box, cfg, c,
                              1, 1), tol=0.0)


def _close(out, ref, tol=1e-12):
    fmax = float(ref[0].abs().max())
    assert fmax > 1.0
    assert float((out[0] - ref[0]).abs().max()) <= tol * fmax
    for a, b in zip(out[1:], ref[1:]):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_list_stays_complete_between_rebuilds():
    """Steps of the deck without a rebuild, then random moves of up to
    0.45 skin per atom: the sweep over the set-up's list equals the
    stencil oracle on the moved atoms."""
    script = _peptide(thermo=0)
    script.run_string("run 0")
    sim = script.sim
    nb0 = int(sim._carry[1].nbuilds)
    script.run_string("run 4")
    s, neigh, _ = sim._carry
    assert int(neigh.nbuilds) == nb0      # the list of the set-up
    c = sim.pair.kernel_coeffs(s.x, *sim._special_weights())
    cfg = sim._neigh_cfg
    rng = np.random.default_rng(11)
    kick = rng.standard_normal(s.x.shape)
    kick *= (0.45 * cfg.skin * rng.uniform(0, 1, (len(kick), 1))
             / np.linalg.norm(kick, axis=1, keepdims=True))
    for x in (s.x, neigh.xhold + torch.as_tensor(kick)
              * neigh.valid[:, None]):
        assert not bool(cg.displacement_exceeded(x, neigh.xhold, neigh.valid,
                                                 s.box, cfg.skin))
        out = b5.charmm_cellgrid(x, s.q, s.type, neigh.pairs, neigh.npairs,
                                 s.box, cfg, c, True, True)
        ref = b5.charmm_cellgrid_plain(x, s.q, s.type, neigh.valid, s.tag,
                                       s.special_tags, s.special_codes,
                                       s.box, cfg, c, True, True)
        _close(out, ref)


def test_a_box_move_shrinks_the_rebuild_trigger():
    """The box's z length shrinks by 0.4 skin (its hi face, the atoms not
    remapped) and the two atoms of an image pair across the z face, just
    outside cutneigh at the build, each move 0.45 skin toward the other:
    the pair is in force range but not in the list.  Random moves inside
    the trigger that the box's move leaves keep the list complete."""
    sim, s, neigh, c = _set_up_peptide()
    cfg = sim._neigh_cfg
    skin, shrink = cfg.skin, 0.4 * cfg.skin
    assert neigh.lohold is not None and neigh.hihold is not None
    xh = neigh.xhold.numpy()
    L = s.box.lengths.numpy()
    v = neigh.valid.numpy()
    raw = xh[None, :, :] - xh[:, None, :]            # x_j - x_i
    d = _min_image(raw, L)
    r = np.sqrt((d * d).sum(-1))
    # across the z face, the shrink shortens the image's z offset
    moved = d + np.array([0.0, 0.0, shrink]) * np.sign(raw[..., 2:3]) \
        * (np.abs(raw[..., 2:3]) > L[2] / 2)
    u = d / np.where(r > 0, r, 1.0)[..., None]
    r1 = np.linalg.norm(moved - 0.9 * skin * u, axis=-1)
    ok = (r > cfg.cutneigh) & v[:, None] & v[None, :]
    i, j = np.unravel_index(np.argmin(np.where(ok, r1, np.inf)), r.shape)
    assert r1[i, j] < cfg.cutneigh - skin - 0.5      # in force range
    x = neigh.xhold.clone()
    step = torch.as_tensor(0.45 * skin * u[i, j])
    x[i] += step
    x[j] -= step
    box = s.box.replace(hi=s.box.hi - torch.tensor([0.0, 0.0, shrink],
                                                   dtype=s.box.hi.dtype))
    args = (s.q, s.type)
    oracle = (neigh.valid, s.tag, s.special_tags, s.special_codes)
    assert not bool(cg.displacement_exceeded(x, neigh.xhold, neigh.valid,
                                             box, skin))
    assert bool(cg.displacement_exceeded(x, neigh.xhold, neigh.valid, box,
                                         skin, neigh.lohold, neigh.hihold))
    ago = cfg.every * -(-max(cfg.delay, 1) // cfg.every)
    assert decide_rebuild(s.replace(x=x, box=box), neigh.replace(ago=ago),
                          sim._ctx)
    out = b5.charmm_cellgrid(x, *args, neigh.pairs, neigh.npairs, box, cfg,
                             c, False, False)
    ref = b5.charmm_cellgrid_plain(x, *args, *oracle, box, cfg, c, False,
                                   False)
    miss = (out[0] - ref[0]).abs().sum(-1)
    assert set(torch.nonzero(miss > 1e-9 * float(ref[0].abs().max()))
               .flatten().tolist()) == {i, j}

    rng = np.random.default_rng(12)
    kick = rng.standard_normal(xh.shape)
    kick *= (0.9 * 0.5 * (skin - shrink) * rng.uniform(0, 1, (len(kick), 1))
             / np.linalg.norm(kick, axis=1, keepdims=True))
    x = neigh.xhold + torch.as_tensor(kick) * neigh.valid[:, None]
    assert not bool(cg.displacement_exceeded(
        x, neigh.xhold, neigh.valid, box, skin, neigh.lohold, neigh.hihold))
    out = b5.charmm_cellgrid(x, *args, neigh.pairs, neigh.npairs, box, cfg,
                             c, True, True)
    ref = b5.charmm_cellgrid_plain(x, *args, *oracle, box, cfg, c, True,
                                   True)
    _close(out, ref)


def test_main_path_builds_at_each_rebin_and_sweeps_the_list():
    script = _peptide()
    b5.counts.reset()
    bpl.counts.reset()
    script.run_string("run 0")
    script.run_string("run 10")
    sim = script.sim
    neigh = sim._carry[1]
    # set-up, then a segment of 5 steps and an energy evaluation twice
    assert b5.counts.plain_calls == 1 + 2 * (5 + 1)
    assert bpl.counts.plain_calls == sim.grid_setups + int(neigh.nbuilds) - 1
    assert sim.grid_setups == 1
    assert b5.counts.kernel_launches == bpl.counts.kernel_launches == 0
    s = sim._carry[0]
    c = sim.pair.kernel_coeffs(s.x, *sim._special_weights())
    with pytest.raises(ValueError, match="no pair list"):
        b5.charmm_cellgrid(s.x, s.q, s.type, None, None, s.box,
                           sim._neigh_cfg, c, False, False)
