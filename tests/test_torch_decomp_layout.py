"""The cell grid's decomposition over ranks, in one process on the CPU
(``tpumd_torch/parallel/decomp.py``, ``halo.py``), with the plain versions
of the kernels.

* The processor grid of P = 1-8 ranks on 3^3-8^3 cell grids: z-slabs where
  P <= nz, else (z, y) pencils with pz <= nz and py <= ny (uneven blocks
  where p does not divide n); every global cell owned by exactly one rank;
  every stencil neighbour of an owned cell present in the rank's local
  grid, at its global cell and with the seam shift that the one-card
  stencil's wrap gives it.  A world size that cannot be laid out raises,
  naming the grid.
* A split axis of 2 cells: both halo planes come from the one other rank,
  one of them shifted by the box length.
* Migration's destinations at a re-bin: an atom whose cell left the block
  goes to the z neighbour, then the y neighbour, that owns it; one bound
  past a neighbouring block raises, naming its tag.
* Local grids assembled by index from the global grid of a running deck
  (in.lj 8^3 and the 2,048-atom eam deck on ``bench_targets.eam_funcfl``,
  both on 4^3 cells), as 4 z-slabs and as 2 x 2 pencils: each owned row's
  list entries are the global list's (the same atoms, in the same order),
  and its forces equal the global sweep's bit for bit in f64: B1 for
  lj/cut, and for EAM B3, F'(rho) assembled into the halos, then B4.  The
  ranks' energies and virials sum to the global ones (1e-12 relative).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpumd_torch.bench_targets import IN_EAM, IN_LJ, eam_funcfl
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import eam_cellgrid as b34
from tpumd_torch.ops import lj_cellgrid as b1
from tpumd_torch.parallel import decomp as dc
from tpumd_torch.parallel import halo
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)


def _cfg(n):
    return cg.CellGridConfig(cutneigh=2.8, skin=0.3, nx=n, ny=n, nz=n, cap=4)


@pytest.mark.parametrize("n", range(3, 9))
@pytest.mark.parametrize("nprocs", range(1, 9))
def test_processor_grid_covers_every_cell_once(nprocs, n):
    cfg = _cfg(n)
    try:
        pz, py = dc.processor_grid(n, n, nprocs)
    except ValueError as e:
        # no pz <= nz, py <= ny with pz py = P
        assert not any(nprocs % pz == 0 and nprocs // pz <= n
                       for pz in range(1, n + 1))
        assert f"nz {n}" in str(e)
        return
    assert pz * py == nprocs and pz <= n and py <= n
    if nprocs <= n:
        assert (pz, py) == (nprocs, 1)
    owners = np.zeros(cfg.ncells, int)
    offs = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]
    for rank in range(nprocs):
        lay = dc.GridLayout(cfg, pz, py, rank)
        lc = lay.local_cfg
        gcell, shift, owned = lay.cell_maps
        owners[gcell[owned]] += 1
        sizes = np.diff(lay.zb)
        assert sizes.max() - sizes.min() <= 1 and sizes.min() >= 1
        assert lc.nz == sizes[lay.iz] + 2 * (pz > 1)
        assert (lc.nx, lc.cap) == (cfg.nx, cfg.cap)
        gc = gcell.reshape(lc.nz, lc.ny, lc.nx)
        sh = shift.reshape(lc.nz, lc.ny, lc.nx, 3)
        for lz, ly, lx in zip(*np.nonzero(owned.reshape(lc.nz, lc.ny,
                                                        lc.nx))):
            g = gc[lz, ly, lx]
            gz, gy, gx = g // (n * n), (g // n) % n, g % n
            for dz, dy, dx in offs:
                # the one-card stencil: the wrapped cell, at the image of
                # its wrap correction; a local grid holds it in place
                z, y = gz + dz, gy + dy
                want = ((z % n) * n + y % n) * n + (gx + dx) % n
                # a split axis's halo holds it without a wrap
                assert pz == 1 or 0 <= lz + dz < lc.nz
                assert py == 1 or 0 <= ly + dy < lc.ny
                lzz, lyy = (lz + dz) % lc.nz, (ly + dy) % lc.ny
                assert gc[lzz, lyy, (lx + dx) % lc.nx] == want
                if pz > 1:
                    assert sh[lzz, lyy, 0, 2] == z // n
                if py > 1:
                    assert sh[lzz, lyy, 0, 1] == y // n
    assert (owners == 1).all()


def test_split_axis_of_two_cells_takes_both_halos_from_one_rank():
    cfg = _cfg(4)
    cfg = dataclasses.replace(cfg, nz=2)
    for rank, lo_shift, hi_shift in ((0, -1, 0), (1, 0, 1)):
        lay = dc.GridLayout(cfg, 2, 1, rank)
        assert lay.zlo == lay.zhi == 1 - rank
        assert lay.local_cfg.nz == 3
        gcell, shift, owned = lay.cell_maps
        per = cfg.ny * cfg.nx
        other = 1 - rank
        # both halo planes are the other rank's one plane
        assert (gcell[:per] // per == other).all()
        assert (gcell[-per:] // per == other).all()
        assert (shift[:per, 2] == lo_shift).all()
        assert (shift[-per:, 2] == hi_shift).all()
        assert (gcell[per:2 * per] // per == rank).all()
        assert owned[per:2 * per].all() and not owned[:per].any()


def test_a_world_that_cannot_be_laid_out_raises():
    with pytest.raises(ValueError, match="nz 3 planes and ny 3 rows"):
        dc.processor_grid(3, 3, 7)
    with pytest.raises(ValueError, match="processor grid"):
        dc.GridLayout(_cfg(3), 4, 1, 0)
    with pytest.raises(ValueError, match="processor grid"):
        dc.GridLayout(_cfg(3), 3, 4, 0)


class _Recorder:
    """A mesh that records the rows sent and receives none."""

    def __init__(self):
        self.sent = []

    def exchange(self, sends, recvs):
        self.sent.append([(peer, t.clone(), tag) for peer, t, tag in sends])
        for _, t, _ in recvs:
            t.zero_()


def test_migration_sends_each_atom_toward_its_block():
    cfg = _cfg(8)
    lay = dc.GridLayout(cfg, 4, 2, 2)          # iz 1 (planes 2-3), iy 0
    assert (lay.iz, lay.iy, lay.zlo, lay.zhi, lay.ylo) == (1, 0, 0, 4, 3)
    # (tag, z cell, y cell): stays; z down; z up; y up; z up then y
    atoms = [(1, 2, 1), (2, 1, 0), (3, 4, 3), (4, 3, 5), (5, 5, 7),
             (6, 3, 0)]
    rows = torch.tensor([[0.5, y + 0.5, z + 0.5, t] for t, z, y in atoms],
                        dtype=torch.float64)

    def block_of(r):
        return lay.blocks_of_cells(r[:, 2].floor().long(),
                                   r[:, 1].floor().long())
    mesh = _Recorder()
    kept = halo.migrate(lay, mesh, rows, block_of, 3)
    assert sorted(kept[:, 3].tolist()) == [1, 6]
    # rounds: z counts, z rows, y counts, y rows; a message's last row is
    # the zero pad
    (zdown, zup), (ydown, yup) = mesh.sent[1], mesh.sent[3]
    assert (zdown[0], zdown[2]) == (lay.zlo, halo.DOWN)
    assert (zup[0], zup[2]) == (lay.zhi, halo.UP)
    assert zdown[1][:-1, 3].tolist() == [2]
    assert zup[1][:-1, 3].tolist() == [3, 5]
    assert yup[0] == lay.yhi and yup[1][:-1, 3].tolist() == [4]
    assert ydown[1].shape[0] == 1
    far = torch.tensor([[0.5, 0.5, 6.5, 9]], dtype=torch.float64)
    with pytest.raises(RuntimeError, match=r"atoms \[9\]"):
        halo.migrate(lay, _Recorder(), far, block_of, 3)


def _deck_state(deck, steps):
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    script.run_string(f"run {steps}")
    s, neigh, _ = sim._carry
    return sim, s, neigh


@pytest.fixture(scope="module")
def lj_deck():
    return _deck_state(IN_LJ.format(n=8), 12)


@pytest.fixture(scope="module")
def eam_deck(tmp_path_factory):
    pot = tmp_path_factory.mktemp("eam") / "Cu.eam"
    eam_funcfl(str(pot))
    return _deck_state(IN_EAM.format(n=8, potential=pot), 8)


def _global_list(sim, s, neigh):
    cfg = sim._neigh_cfg
    assert (cfg.nz, cfg.ny, cfg.nx) == (4, 4, 4)
    pairs, npairs, _, over = bpl.cellgrid_pairlist(
        s.x, neigh.valid, s.tag, None, None, s.box, cfg, sim._ctx.pairlist_k)
    assert not bool(over)
    return cfg, pairs, npairs


def _local(lay, sim, s, neigh):
    """(local state, valid, owned, rows, pairs, npairs, global slot) of a
    rank's grid assembled by index."""
    sl, valid = dc.assemble_slots(lay, s, neigh.valid)
    gslot, _, owned_slot = (torch.as_tensor(a) for a in lay.slot_maps)
    owned = valid & owned_slot
    pairs, npairs, _, over = bpl.cellgrid_pairlist(
        sl.x, valid, sl.tag, None, None, lay.list_box(s.box), lay.local_cfg,
        sim._ctx.pairlist_k)
    assert not bool(over)
    return sl, valid, owned, torch.nonzero(owned).reshape(-1), pairs, \
        npairs, gslot


def _same_entries(rows, gslot, pairs, npairs, gpairs, gnpairs):
    g = gslot[rows]
    assert torch.equal(npairs[rows], gnpairs[g])
    k = int(npairs[rows].max())
    live = torch.arange(k)[None, :] < npairs[rows][:, None]
    mapped = gslot[bpl.unpack(pairs[rows, :k])[0].long()]
    want = bpl.unpack(gpairs[g, :k])[0].long()
    assert torch.equal(torch.where(live, mapped, -1),
                       torch.where(live, want, -1))


LAYOUTS = {"slabs": (4, 1), "pencils": (2, 2)}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lj_local_grids_equal_the_global_sweep(layout, lj_deck):
    sim, s, neigh = lj_deck
    cfg, gp, gn = _global_list(sim, s, neigh)
    c = sim.pair.kernel_coeffs()
    rows_g = torch.nonzero(neigh.valid).reshape(-1)
    fg, eg, vg = b1.lj_cellgrid(s.x, neigh.valid, s.box, cfg, c, 1, 1,
                                (gp, gn, rows_g))
    e_sum, v_sum, seen = 0.0, torch.zeros(6, dtype=torch.float64), 0
    for rank in range(4):
        lay = dc.GridLayout(cfg, *LAYOUTS[layout], rank)
        sl, valid, owned, rows, lp, ln, gslot = _local(lay, sim, s, neigh)
        _same_entries(rows, gslot, lp, ln, gp, gn)
        f, e, v = b1.lj_cellgrid(sl.x, owned, s.box, lay.local_cfg, c, 1, 1,
                                 (lp, ln, rows))
        assert torch.equal(f[rows], fg[gslot[rows]])
        assert not f[~owned].any()
        e_sum, v_sum, seen = e_sum + e, v_sum + v, seen + rows.numel()
    assert seen == sim.natoms
    np.testing.assert_allclose(float(e_sum), float(eg), rtol=1e-12)
    np.testing.assert_allclose(v_sum.numpy(), vg.numpy(), rtol=1e-12,
                               atol=1e-12 * float(vg.abs().max()))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_eam_local_grids_equal_the_global_sweeps(layout, eam_deck):
    sim, s, neigh = eam_deck
    cfg, gp, gn = _global_list(sim, s, neigh)
    tab = sim.pair.kernel_tables(s.x)
    rows_g = torch.nonzero(neigh.valid).reshape(-1)
    plist = (gp, gn, rows_g)
    _, fpg, eeg = b34.eam_rho_cellgrid(s.x, neigh.valid, s.box, cfg, tab, 1,
                                       plist)
    fg, epg, vg = b34.eam_force_cellgrid(s.x, neigh.valid, fpg, s.box, cfg,
                                         tab, 1, 1, plist)
    e_sum, v_sum = 0.0, torch.zeros(6, dtype=torch.float64)
    for rank in range(4):
        lay = dc.GridLayout(cfg, *LAYOUTS[layout], rank)
        sl, valid, owned, rows, lp, ln, gslot = _local(lay, sim, s, neigh)
        _same_entries(rows, gslot, lp, ln, gp, gn)
        lpl = (lp, ln, rows)
        _, fp, ee = b34.eam_rho_cellgrid(sl.x, owned, s.box, lay.local_cfg,
                                         tab, 1, lpl)
        assert torch.equal(fp[rows], fpg[gslot[rows]])
        assert not fp[~owned].any()
        # F'(rho) of the halo slots from their owners
        fp = torch.where(owned, fp, torch.where(valid, fpg[gslot], 0.0))
        f, ep, v = b34.eam_force_cellgrid(sl.x, owned, fp, s.box,
                                          lay.local_cfg, tab, 1, 1, lpl)
        assert torch.equal(f[rows], fg[gslot[rows]])
        e_sum, v_sum = e_sum + ee + ep, v_sum + v
    np.testing.assert_allclose(float(e_sum), float(eeg + epg), rtol=1e-12)
    np.testing.assert_allclose(v_sum.numpy(), vg.numpy(), rtol=1e-12,
                               atol=1e-12 * float(vg.abs().max()))
