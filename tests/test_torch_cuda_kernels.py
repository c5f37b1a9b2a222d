"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  The file imports torch and tpumd_torch only, so it
runs on a card host without JAX:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.

* LJ (B1, ``lj_cellgrid``) over the grid's pair list: perturbed fcc
  blocks of 6x6x6 and 4x6x6 cells (3^3 and 2x3x3 grids), against the
  plain list sweep and the stencil oracle ``lj_cellgrid_plain``;
* LJ+FENE (B2, ``lj_fene_cellgrid``) over the set-up's pair list: the
  grid-ordered state of generated chain decks after setup, on a 5^3 grid
  and on a 2^3 grid where bonds count at the minimum image, as it is and
  with one bond stretched to 2 sigma (past cutneigh), against the plain
  list sweep and the stencil oracle ``lj_fene_cellgrid_plain``;
* EAM density and force passes (B3 ``eam_rho_cellgrid`` and B4
  ``eam_force_cellgrid``, both over the grid's pair list): perturbed fcc
  lattices of the generated Cu-like potential, 5^3 and 4^3 lattice cells
  (3^3 and 2^3 grids); the force passes take the plain density pass's F'
  and are held against the plain list sweep and the stencil oracle
  ``eam_force_cellgrid_plain``; the density pass is held on rho, F' and
  the embedding energy against its plain list sweep and the stencil
  oracle ``eam_rho_cellgrid_plain`` (f32 2e-6, f64 1e-13 of their
  largest), also on the 32k in.eam grid (20^3 lattice cells, 12^3);
* the pair list refresh (``refresh_pairlist``): on a 3^3 in.lj grid with
  one atom moved past skin/2, the list (and its positions) rebuilt in
  place equal to a fresh build, the refresh counted; with no atom past
  skin/2, the list left as it was; and on the peptide replica's 4^3 grid
  (cap 368, the wide G) with its special entries;
* the pair list build (``cellgrid_pairlist``), with each G the launch
  rule can pick forced (``lanes``): the grid-ordered state of the peptide
  deck with the rhodo_class settings after set-up (a 2^3 grid of cap 368,
  every neighbour cell met at two images) and of its 2x2x2 replica (a 4^3
  grid): the plain build's live entries (up to each row's count) as
  arrays, counts, longest row and overflow flag, at the set-up's K and at
  a K too small; and on generated chute packs' ``p p fs`` grids (9x5x4,
  5x2x3, 5x5x2) with the base-base pairs excluded and with none, and on
  the 4^3 grid with random group bits and two group-bit pairs excluded;
* lj/charmm/coul/long (B5, ``charmm_cellgrid``) over the set-up's pair
  list, on the peptide's 2^3 grid and its 1x1x2 replica's 2x2x4 grid,
  against the plain list sweep and the stencil oracle
  ``charmm_cellgrid_plain``: special weights, charges and the kspace
  exclusion term included; without a list it raises; and on the
  water_npt golden's grid after 20 steps of fix npt iso, B5 launched once
  per force evaluation, then over the carried list with the atoms and
  the box dilated about the centre as a barostat's half step does,
  against the plain list sweep and the stencil oracle at that box;
* gran/hooke/history and gran/hertz/history (B6, ``gran_cellgrid``, and
  its HERTZ variant) over the grid's pair list:
  the grid-ordered state of generated chute packs after 30 steps on the
  card, a 9x5x4 grid, a 5x2x3 grid (y periodic with 2 cells) and a 5x5x2
  grid (z non-periodic with 2 cells), z non-periodic, with the deck's
  coefficients (dampflag 0, the frozen base's bit, the base-base
  exclusion) and with dampflag 1 and limit_damping, the history as it is
  and scaled by 40 (most contacts slip); forces, torques and the history
  tables after the sweep (tags equal) against the plain list sweep and
  the stencil oracle ``gran_compact_sums``, both shearupdate values;
* the row gather (P1, ``gather_rows``): bit for bit equal to its plain
  version for f32, f64 and int32 tables of widths 1-16, 24, 32 and 128
  with one index and (M,) and (M, K) indices up to the last row, past
  the narrow copy's least rows and no whole number of its tiles, and
  where the table, the indices or the output start one element past
  alignment; the matrix engine on the card (lj/cut on a small triclinic
  box and the 480-sphere chute pack on matrix rows) equals the CPU's
  thermo to 1e-10 after 20 steps, with a launch of P1 per force
  evaluation and no plain call;
* the analysis layer: pe/atom and stress/atom from B1's and B5's halved
  per-slot outputs (their per-atom variant) against the matrix engine's
  plain tallies (B1) and B5's plain list sweep on the CPU, and the
  distance computes (rdf, coord/atom, cluster/atom, cna/atom, centro/atom,
  orientorder/atom) over the list kernel's occasional list against their
  plain all-pairs versions on the card;
* B1's special-weighted variant over the hyb cell 2x2x2's list, against
  the plain list sweep and the stencil oracle matching the special tags;
  the hyb cell on the grid and the ellipsoid liquid, card = CPU; the r/k
  split on two streams = the fused evaluation at the peptide;
* the decomposed grid: the list kernel and B1 on each rank's local grid
  (4 z-slabs, 2 x 2 pencils of an 8^3 in.lj grid, assembled by index with
  the halos' seam shift) against the global launch, owned row by row.

f32 and f64, every energy/virial flag combination; tolerances as in
chip_smoke.py: forces 5e-5 (f32) or 1e-12 (f64) of max|f|, energies and
virial the same relative to their size.
"""

import os

import numpy as np
import pytest
import torch

from tpumd_torch.bench_targets import EAM_A0, IN_CHAIN, IN_CHUTE, \
    IN_RHODO_CLASS, chain_data, chute_data, eam_funcfl
from tpumd_torch.core.create import create_atoms_lattice
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.state import Box, make_state, wrap_pbc
from tpumd_torch.interop import pair_from_numpy
from tpumd_torch.models.pair_eam import PairEAM
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import charmm_cellgrid as b5
from tpumd_torch.ops import eam_cellgrid as b34
from tpumd_torch.ops import gran_cellgrid as b6
from tpumd_torch.ops.cellgrid_gran import GranCoeffs
from tpumd_torch.ops import lj_cellgrid as b1
from tpumd_torch.ops import gather as p1
from tpumd_torch.ops import lj_fene_cellgrid as b2
from tpumd_torch.script.parser import LammpsScript

TOL = {torch.float32: 5e-5, torch.float64: 1e-12}
# B3 against its plain versions: the same pairs, summed in another order
TOL_LIST = {torch.float32: 2e-6, torch.float64: 1e-13}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "peptide")
FLAGS = ((1, 1), (0, 0), (1, 0), (0, 1))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _fcc_grid(block, dtype, seed=5, lattice=("fcc", 0.8442, "lj"),
              amp=0.05, cutneigh=2.8, skin=0.3):
    """Slot-ordered positions, validity, box, grid and pair list (pairs,
    npairs, rows; built by the kernel) of a perturbed lattice of block
    cells (in.lj's fcc by default)."""
    lat = Lattice(lattice[0], lattice[1], units=lattice[2])
    hi = np.asarray(block) * lat.spacing
    x, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    x = x + np.random.default_rng(seed).uniform(-amp, amp, x.shape)
    box = Box.orthogonal(np.zeros(3), hi, device="cuda", dtype=dtype)
    s = wrap_pbc(make_state(x, np.zeros_like(x), t, box, device="cuda",
                            dtype=dtype))
    cfg = cg.choose_cellgrid_config(box, cutneigh, skin, len(x))
    s = cg.pad_state(s, cfg.capacity)
    valid0 = torch.arange(cfg.capacity, device="cuda") < len(x)
    perm, valid, _, over = cg.bin_permutation(s.x, valid0, s.box, cfg)
    assert not bool(over)
    s = cg.apply_permutation(s, perm, valid)
    pairs, npairs, _, over = bpl.cellgrid_pairlist(
        s.x, valid, s.tag, None, None, box, cfg,
        cg.pairlist_kmax(box, cutneigh, len(x)))
    assert not bool(over)
    return s.x, valid, box, cfg, (pairs, npairs,
                                  cg.row2slot_from_tags(s.tag, len(x)))


def _chain_grid(tmp_path, natoms, chain_len, dtype, stretch=False):
    """(x, valid, tag, bond_tags, box, cfg, lj, fene, the set-up's pair
    list) of a generated chain deck after set-up on the card; with
    stretch, the second atom of the first chain moved to 2 sigma from the
    first (past cutneigh) before a fresh list is built."""
    from tpumd_torch.md.verlet import grid_pairlist
    path = tmp_path / f"data.chain.{natoms}"
    chain_data(path, natoms, chain_len)
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.run_string(IN_CHAIN.format(data=path))
    script.sim.verbose = False
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    x = s.x
    if stretch:
        a, b = (int(neigh.row2slot[k]) for k in (0, 1))
        d = x[b] - x[a]
        x = x.clone()
        x[b] = x[a] + 2.0 * d / d.norm()
        fields, _ = grid_pairlist(s.replace(x=x), neigh.valid, sim._ctx)
        neigh = neigh.replace(**fields)
    box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
    return (x.to(dtype), neigh.valid, s.tag, s.bond_tags, box,
            sim._neigh_cfg, sim.pair.kernel_coeffs(),
            sim._ctx.kernel_bond.kernel_coeffs(),
            (neigh.pairs, neigh.npairs, neigh.bond_slots, neigh.row2slot))


def _close(kernel_out, plain_out, tol):
    torch.cuda.synchronize()
    fk, fp = kernel_out[0], plain_out[0]
    fmax = float(fp.abs().max())
    assert float((fk - fp).abs().max()) <= tol * fmax
    for k, p in zip(kernel_out[1:], plain_out[1:]):
        assert (k is None) == (p is None)
        if p is not None:
            assert float((k - p).abs().max()) <= tol * float(p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cuda_kernel_matches_plain(dtype):
    """B1, the LJ kernel over the grid's pair list."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    eps, sig, cut = np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2))
    eps[1, 1], sig[1, 1], cut[1, 1] = 1.0, 1.0, 2.5
    c = pair_from_numpy(eps, sig, cut).kernel_coeffs()
    for block in ((6, 6, 6), (4, 6, 6)):
        x, valid, box, cfg, plist = _fcc_grid(block, dt)
        for ef, vf in FLAGS:
            n0 = b1.counts.kernel_launches
            out = b1.lj_cellgrid(x, valid, box, cfg, c, ef, vf, plist)
            assert b1.counts.kernel_launches == n0 + 1
            _close(out, b1.lj_pairlist_plain(x, box, c, ef, vf, *plist[:2]),
                   TOL[dt])
            _close(out, b1.lj_cellgrid_plain(x, valid, box, cfg, c, ef, vf),
                   TOL[dt])
        with pytest.raises(ValueError, match="no pair list"):
            b1.lj_cellgrid(x, valid, box, cfg, c, 0, 0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_pairlist_refresh_cuda_kernel_matches_plain(dtype):
    """The refresh: a clear gate leaves the list, its positions and the
    counts alone; an atom moved past skin/2 rebuilds all three in place,
    equal to a fresh build on the moved positions."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    x, valid, box, cfg, plist = _fcc_grid((6, 6, 6), dt)
    tag = torch.where(valid, torch.cumsum(valid.int(), 0), 0).to(torch.int32)
    K = plist[0].shape[1]
    stat = bpl.new_stat(x.device)
    hold = bpl.pairlist_hold(x, valid, tag, None, None, cfg)
    pairs, npairs, _, _ = bpl.cellgrid_pairlist(
        x, valid, tag, None, None, box, cfg, K, stat=stat, hold=hold)
    assert torch.equal(hold.x, x)
    before = (pairs.clone(), npairs.clone(), hold.x.clone(), stat.clone())
    n0 = bpl.refresh_counts.kernel_launches
    bpl.refresh_pairlist(x, valid, box, cfg, pairs, npairs, stat, hold)
    torch.cuda.synchronize()
    assert bpl.refresh_counts.kernel_launches == n0 + 1
    assert torch.equal(pairs, before[0]) and torch.equal(npairs, before[1])
    assert torch.equal(hold.x, before[2])
    assert torch.equal(stat[:3], before[3][:3]) and int(stat[2]) == 0
    moved = x.clone()
    k = int(torch.nonzero(valid)[0])
    moved[k, 0] += 0.6 * cfg.skin
    bpl.refresh_pairlist(moved, valid, box, cfg, pairs, npairs, stat, hold)
    fresh = bpl.cellgrid_pairlist_plain(moved, valid, tag, None, None, box,
                                        cfg, K)
    _same_list((pairs, npairs, stat[0], stat[1] != 0), fresh)
    assert torch.equal(hold.x, moved) and int(stat[2]) == 1
    assert not torch.equal(_live(pairs, npairs), _live(*before[:2]))
    # where the rule takes the wide G: the peptide replica's 4^3 grid of
    # cap 368, its special entries kept
    _, _, args = _charmm_grid("2 2 2", dt)
    x, valid, tag, stags, scodes, box, cfg, K = args
    assert cfg.cap > 64
    stat = bpl.new_stat(x.device)
    hold = bpl.pairlist_hold(x, valid, tag, stags, scodes, cfg)
    pairs, npairs, _, _ = bpl.cellgrid_pairlist(*args, stat=stat, hold=hold)
    moved = x.clone()
    k = int(torch.nonzero(valid)[0])
    moved[k, 0] += 0.6 * cfg.skin
    bpl.refresh_pairlist(moved, valid, box, cfg, pairs, npairs, stat, hold)
    _same_list((pairs, npairs, stat[0], stat[1] != 0),
               bpl.cellgrid_pairlist_plain(moved, *args[1:]))
    assert int(stat[2]) == 1 and torch.equal(hold.x, moved)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_lj_fene_cuda_kernel_matches_plain(dtype, tmp_path):
    """B2, the LJ+FENE cell-grid kernel."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    for (natoms, chain_len), stretch in (((500, 25), False),
                                         ((500, 25), True),
                                         ((60, 10), False)):
        *args, plist = _chain_grid(tmp_path, natoms, chain_len, dt,
                                   stretch)
        x, valid, tag, btags, box, cfg, lj, fene = args
        for ef, vf in FLAGS:
            n0 = b2.counts.kernel_launches
            out = b2.lj_fene_cellgrid(x, valid, box, cfg, lj, fene, ef, vf,
                                      plist)
            assert b2.counts.kernel_launches == n0 + 1
            _close(out, b2.lj_fene_pairlist_plain(
                x, box, lj, fene, ef, vf, *plist[:3]), TOL[dt])
            _close(out, b2.lj_fene_cellgrid_plain(*args, ef, vf), TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_eam_cuda_kernels_match_plain(dtype, tmp_path):
    """B3 and B4, the EAM density and force kernels."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    eam_funcfl(tmp_path / "Cu.eam")
    pair = PairEAM(1)
    pair.coeff(1, 1, 1, 1, str(tmp_path / "Cu.eam"))
    pair.init()
    for nlat in (5, 4, 20):
        x, valid, box, cfg, plist = _fcc_grid(
            (nlat,) * 3, dt, lattice=("fcc", EAM_A0, "metal"), amp=0.15,
            cutneigh=pair.cutmax + 1.0, skin=1.0)
        assert cfg.nx == {5: 3, 4: 2, 20: 12}[nlat]
        tab = pair.kernel_tables(x)
        for ef, vf in FLAGS:
            n0 = b34.rho_counts.kernel_launches
            rho = b34.eam_rho_cellgrid(x, valid, box, cfg, tab, ef, plist)
            assert b34.rho_counts.kernel_launches == n0 + 1
            plain = b34.eam_rho_cellgrid_plain(x, valid, box, cfg, tab, ef)
            _close(rho, plain, TOL_LIST[dt])
            _close(rho, b34.eam_rho_pairlist_plain(x, valid, box, tab, ef,
                                                   *plist[:2]), TOL_LIST[dt])
            # F' of empty slots is 0 in both
            assert float(rho[1][~valid].abs().max()) == 0.0
            n0 = b34.force_counts.kernel_launches
            out = b34.eam_force_cellgrid(x, valid, plain[1], box, cfg, tab,
                                         ef, vf, plist)
            assert b34.force_counts.kernel_launches == n0 + 1
            _close(out, b34.eam_force_pairlist_plain(
                x, plain[1], box, tab, ef, vf, *plist[:2]), TOL[dt])
            _close(out, b34.eam_force_cellgrid_plain(
                x, valid, plain[1], box, cfg, tab, ef, vf), TOL[dt])
        with pytest.raises(ValueError, match="no pair list"):
            b34.eam_rho_cellgrid(x, valid, box, cfg, tab, 0, None)


def _charmm_grid(replicate, dtype):
    """(the arguments of charmm_cellgrid, those of the stencil oracle
    charmm_cellgrid_plain, those of cellgrid_pairlist) for the
    rhodo_class deck on the peptide, replicated as given, after set-up on
    the card; the list is the one the set-up built."""
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.run_string(IN_RHODO_CLASS.format(golden=GOLDEN).replace(
        "replicate       2 2 4", f"replicate       {replicate}"))
    script.sim.verbose = False
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    x = s.x.to(dtype)
    box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
    cfg = sim._neigh_cfg
    c = sim.pair.kernel_coeffs(x, *sim._special_weights())
    q = s.q.to(dtype)
    return ((x, q, s.type, neigh.pairs, neigh.npairs, box, cfg, c),
            (x, q, s.type, neigh.valid, s.tag, s.special_tags,
             s.special_codes, box, cfg, c),
            (x, neigh.valid, s.tag, s.special_tags, s.special_codes, box,
             cfg, sim._ctx.pairlist_k))


def _live(pairs, npairs):
    """The rows' live entries, the tails past npairs (unspecified in a
    kernel's list) zeroed."""
    k = torch.arange(pairs.shape[1], device=pairs.device)
    return torch.where(k < npairs[:, None].long(), pairs, 0)


def _same_list(out, plain):
    """A build's (pairs, npairs, longest row, overflow) equal to the plain
    build's: live entries as arrays, in order."""
    torch.cuda.synchronize()
    assert torch.equal(out[1], plain[1])
    assert int(out[2]) == int(plain[2])
    assert bool(out[3]) == bool(plain[3])
    assert torch.equal(_live(*out[:2]), _live(*plain[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cellgrid_pairlist_cuda_kernel_matches_plain(dtype):
    """The pair list build kernel with each G forced, on the peptide's
    2^3 grid (2-cell periodic axes) and its replica's 4^3 grid, S special
    entries a slot: the plain build's live entries as arrays, equal
    counts, longest row and overflow flag, also with K too small."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    for replicate, grid in (("1 1 1", (2, 2, 2)), ("2 2 2", (4, 4, 4))):
        _, _, args = _charmm_grid(replicate, dt)
        cfg = args[-2]
        assert (cfg.nx, cfg.ny, cfg.nz) == grid and args[3].shape[1] >= 12
        for k in (args[-1], 64):
            a = args[:-1] + (k,)
            plain = bpl.cellgrid_pairlist_plain(*a)
            assert bool(plain[3]) == (k == 64) and int(plain[2]) > 64
            for lanes in (None,) + bpl.LANES:
                n0 = bpl.counts.kernel_launches
                out = bpl.cellgrid_pairlist(*a, lanes=lanes)
                assert bpl.counts.kernel_launches == n0 + 1
                _same_list(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cellgrid_pairlist_cuda_kernel_on_a_non_periodic_grid(dtype,
                                                              tmp_path):
    """The pair list build kernel on chute packs' p p fs grids, with the
    base-base pairs dropped and with none: the plain build's rows as
    arrays, counts, longest row and overflow flag."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    for dims, grid in (((10, 6, 8), (9, 5, 4)), ((6, 3, 6), (5, 2, 3)),
                       ((6, 6, 4), (5, 5, 2))):
        args, planes, coeffs = _gran_grid(tmp_path, dims, dt)[0][:3]
        x, tag, valid, _, _, box, cfg = args
        assert (cfg.nx, cfg.ny, cfg.nz) == grid
        assert box.periodic == (True, True, False)
        assert coeffs[0].exclude_bits == ((2, 2),)
        for excl in (coeffs[0].exclude_bits, ()):
            a = (x, valid, tag, None, None, box, cfg, 16, planes[4], excl)
            plain = bpl.cellgrid_pairlist_plain(*a)
            assert not bool(plain[3])
            for lanes in (None,) + bpl.LANES:
                n0 = bpl.counts.kernel_launches
                out = bpl.cellgrid_pairlist(*a, lanes=lanes)
                assert bpl.counts.kernel_launches == n0 + 1
                _same_list(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cellgrid_pairlist_cuda_kernel_with_exclusions_on_a_periodic_grid(
        dtype):
    """The pair list build kernel on the peptide replica's periodic 4^3
    grid, its special codes kept, with atoms in random groups and two
    group-bit pairs excluded: the plain build's rows as arrays, counts
    and longest row, and fewer entries than without the exclusions."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    _, _, args = _charmm_grid("2 2 2", dt)
    x, valid = args[:2]
    gen = np.random.default_rng(11)
    gmask = torch.as_tensor(1 + 2 * gen.integers(0, 2, x.shape[0])
                            + 4 * gen.integers(0, 2, x.shape[0]),
                            dtype=torch.int32, device="cuda")
    a = args + (gmask, ((2, 2), (2, 4)))
    plain = bpl.cellgrid_pairlist_plain(*a)
    full = bpl.cellgrid_pairlist_plain(*args)
    assert not bool(plain[3])
    assert int(plain[1].sum()) < int(full[1].sum())
    for lanes in (None,) + bpl.LANES:
        n0 = bpl.counts.kernel_launches
        out = bpl.cellgrid_pairlist(*a, lanes=lanes)
        assert bpl.counts.kernel_launches == n0 + 1
        _same_list(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_charmm_cuda_kernel_matches_plain(dtype):
    """B5, the lj/charmm/coul/long list kernel, against the plain list
    sweep and the stencil oracle."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    for replicate, grid in (("1 1 1", (2, 2, 2)), ("1 1 2", (2, 2, 4))):
        args, oracle, _ = _charmm_grid(replicate, dt)
        cfg = args[6]
        assert (cfg.nx, cfg.ny, cfg.nz) == grid
        for ef, vf in FLAGS:
            n0 = b5.counts.kernel_launches
            out = b5.charmm_cellgrid(*args, ef, vf)
            assert b5.counts.kernel_launches == n0 + 1
            _close(out, b5.charmm_pairlist_plain(*args[:6], args[7], ef,
                                                 vf), TOL[dt])
            _close(out, b5.charmm_cellgrid_plain(*oracle, ef, vf), TOL[dt])
        with pytest.raises(ValueError, match="no pair list"):
            b5.charmm_cellgrid(*args[:3], None, None, *args[5:], 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_charmm_cuda_kernel_under_an_iso_box(dtype, tmp_path):
    """B5 on the water_npt golden's grid after 20 steps of fix npt iso
    (a 100 fs barostat), B5 launched once per force evaluation of the run
    and no plain call; then the atoms and the box dilated 0.2 % about the
    centre, as a barostat's half step does between rebuilds: B5 over the
    carried list, at the dilated box, against the plain list sweep and the
    stencil oracle at that box."""
    import shutil
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    golden = os.path.join(os.path.dirname(GOLDEN), "water_npt")
    shutil.copy(os.path.join(golden, "data.water"), tmp_path)
    with open(os.path.join(golden, "in.test")) as fh:
        deck = [ln for ln in fh.read().splitlines()
                if not ln.startswith(("dump", "run", "fix             1"))]
    deck += ["fix 1 all npt temp 300.0 300.0 100.0 iso 0.0 0.0 100.0",
             "thermo 10"]
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.data_dir = str(tmp_path)
    script.run_string("\n".join(deck))
    script.sim.verbose = False
    b5.counts.reset()
    script.run_string("run 20")
    # set-up, 20 steps, the energies of 2 thermo rows
    assert b5.counts.kernel_launches == 1 + 20 + 2
    assert b5.counts.plain_calls == 0
    sim = script.sim
    s, neigh, _ = sim._carry
    ell = s.box.lengths_np()
    assert ell[0] == ell[1] == ell[2] and abs(ell[0] - 19.0) > 1e-4
    ctr = 0.5 * (s.box.lo + s.box.hi)
    x = torch.where(neigh.valid[:, None], (s.x - ctr) * 1.002 + ctr, s.x)
    box = Box(lo=((s.box.lo - ctr) * 1.002 + ctr).to(dt),
              hi=((s.box.hi - ctr) * 1.002 + ctr).to(dt))
    x = x.to(dt)
    c = sim.pair.kernel_coeffs(x, *sim._special_weights())
    args = (x, s.q.to(dt), s.type, neigh.pairs, neigh.npairs, box,
            sim._neigh_cfg, c)
    oracle = (x, s.q.to(dt), s.type, neigh.valid, s.tag, s.special_tags,
              s.special_codes, box, sim._neigh_cfg, c)
    for ef, vf in FLAGS:
        out = b5.charmm_cellgrid(*args, ef, vf)
        _close(out, b5.charmm_pairlist_plain(*args[:6], args[7], ef, vf),
               TOL[dt])
        _close(out, b5.charmm_cellgrid_plain(*oracle, ef, vf), TOL[dt])


def _gran_grid(tmp_path, dims, dtype):
    """The arguments of gran_cellgrid for a generated chute pack after 30
    steps of the chute deck on the card, the history scaled by 1 and 40."""
    path = tmp_path / "data.chute"
    chute_data(path, *dims)
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.run_string(IN_CHUTE.format(data=path))
    script.sim.verbose = False
    script.run_string("run 30")
    sim = script.sim
    s, neigh, _ = sim._carry
    f = (lambda a: a.to(dtype))
    box = Box(lo=f(s.box.lo), hi=f(s.box.hi), periodic=s.box.periodic)
    planes = (f(s.v), f(s.omega), f(s.radius),
              f(torch.where(s.rmass > 0, s.rmass, 1.0)), s.gmask)
    c = sim.pair.kernel_coeffs()
    damped = c._replace(gammat=0.5 * c.gamman, limit_damping=True)
    # and each with gran/hertz/history's polyhertz (the HERTZ variant)
    coeffs = (c, damped, c._replace(hertz=True),
              damped._replace(hertz=True))
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    return [((f(s.x), s.tag, neigh.valid, neigh.shear_tags,
              f(neigh.shear * k), box, sim._neigh_cfg), planes, coeffs,
             plist) for k in (1.0, 40.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_gran_cuda_kernel_matches_plain(dtype, tmp_path):
    """B6, the gran/hooke/history cell-grid kernel, and its HERTZ
    variant."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    # every axis of 3 cells or more; y periodic with 2 cells; z
    # non-periodic with 2 cells (the aliased offsets dropped)
    for dims, grid in (((10, 6, 8), (9, 5, 4)), ((6, 3, 6), (5, 2, 3)),
                       ((6, 6, 4), (5, 5, 2))):
        for args, planes, coeffs, plist in _gran_grid(tmp_path, dims, dt):
            x, tag, valid, stags, shear, box, cfg = args
            assert (cfg.nx, cfg.ny, cfg.nz) == grid
            for c in coeffs:
                assert isinstance(c, GranCoeffs)
                for shearupdate in (True, False):
                    n0 = b6.counts.kernel_launches
                    h0 = b6.counts.hertz_launches
                    over = torch.zeros(2, dtype=torch.int32, device="cuda")
                    out = b6.gran_cellgrid(*args, c, planes, 1e-4,
                                           shearupdate, plist, over[:1])
                    assert b6.counts.kernel_launches == n0 + 1
                    assert b6.counts.hertz_launches == h0 + c.hertz
                    plain_list = b6.gran_pairlist_plain(
                        x, tag, stags, shear, box, c, planes, 1e-4,
                        shearupdate, *plist[:2], over[1:])
                    # no sphere of these packs has more than KH contacts
                    assert over.tolist() == [0, 0]
                    for plain in (
                            plain_list,
                            b6.gran_compact_sums(*args, c, planes, 1e-4,
                                                 shearupdate)):
                        torch.cuda.synchronize()
                        assert torch.equal(out[2], plain[2])
                        for k, p in zip(out[:2] + out[3:],
                                        plain[:2] + plain[3:]):
                            assert float((k - p).abs().max()) <= TOL[
                                dt] * float(p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64", "i32"])
def test_row_gather_cuda_kernel_equals_plain(dtype):
    """P1, the row gather: a copy, so bit for bit, through its narrow
    copy (a thread a row) and its unit copy."""
    _card()
    from tpumd_torch.ops import _build
    rng = np.random.default_rng(3)
    rows = 1000
    for width in tuple(range(1, 17)) + (24, 32, 128):
        if dtype == "i32":
            table = torch.as_tensor(rng.integers(-2**31, 2**31 - 1,
                                                 (rows, width)),
                                    dtype=torch.int32, device="cuda")
        else:
            table = torch.as_tensor(
                rng.standard_normal((rows, width)), device="cuda",
                dtype={"f32": torch.float32, "f64": torch.float64}[dtype])
        for shape in ((1,), (40003,), (517, 131)):
            idx = torch.as_tensor(rng.integers(0, rows, shape),
                                  dtype=torch.int32, device="cuda")
            idx.view(-1)[-1] = rows - 1
            n0 = p1.counts.kernel_launches
            out = p1.gather_rows(table, idx)
            assert p1.counts.kernel_launches == n0 + 1
            torch.cuda.synchronize()
            assert torch.equal(out, p1.gather_rows_plain(table, idx))
        # a table, an index array and an output each starting one element
        # past an aligned address
        shifted = table.view(-1)[1:1 + (rows - 1) * width].view(rows - 1,
                                                                width)
        ibuf = torch.as_tensor(rng.integers(0, rows - 1, 40004),
                               dtype=torch.int32, device="cuda")
        idx = ibuf[1:]
        assert idx.data_ptr() % 16 != 0
        assert torch.equal(p1.gather_rows(shifted, idx),
                           p1.gather_rows_plain(shifted, idx))
        obuf = torch.empty(idx.numel() * width + 1, dtype=table.dtype,
                           device="cuda")
        out = obuf[1:].view(idx.numel(), width)
        fn = _build.kernel_function("tpumd_row_gather", p1._ARGTYPES)
        assert fn(shifted.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  idx.numel(), width * table.element_size(),
                  torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, p1.gather_rows_plain(shifted, idx))


TRI_DECK = """
units           lj
atom_style      atomic
read_data       {golden}/tri_lj/data.tri
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    every 1 delay 0 check yes
velocity        all create 1.2 4928459 loop geom
fix             1 all nve
timestep        0.005
thermo          10
"""


@pytest.mark.cuda
def test_matrix_engine_on_the_card_equals_the_cpu(tmp_path):
    """The matrix engine (its gathers through P1) on the card against the
    CPU, f64: a triclinic lj/cut deck and the chute pack."""
    _card()
    chute_data(tmp_path / "data.chute", 10, 6, 8)
    decks = {
        "tri": (TRI_DECK.format(golden=os.path.dirname(GOLDEN)),
                ("temp", "epair", "etotal", "press")),
        "chute": (IN_CHUTE.format(data=tmp_path / "data.chute"),
                  ("ke", "c_1", "vol"))}
    for name, (deck, keys) in decks.items():
        rows = {}
        for dev in ("cuda", "cpu"):
            script = LammpsScript(device=dev, dtype=torch.float64)
            script.run_string(deck)
            script.sim.verbose = False
            script.sim.neighbor_mode = "matrix"
            p1.counts.reset()
            script.run_string("run 20")
            rows[dev] = script.sim.last_thermo
            if dev == "cuda":
                # set-up and thermo evaluations and 20 in-step ones, each
                # at least one gather, plus the builds
                assert p1.counts.kernel_launches >= 22
                assert p1.counts.plain_calls == 0
        for k in keys:
            assert rows["cuda"][k] == pytest.approx(rows["cpu"][k],
                                                    rel=1e-10), (name, k)


@pytest.mark.cuda
def test_gran_goldens_on_the_card_equal_the_cpu():
    """tests/golden/gran's granhertz and pour decks, 300 steps on the card
    and on the CPU in f64: ke to 1e-9 relative (the sums' order differs;
    the contacts amplify it), equal atom counts; on
    the card B6 (HERTZ on granhertz) launched once per force evaluation
    and no plain call."""
    _card()
    gran = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "gran")
    for name in ("granhertz", "pour"):
        text = open(os.path.join(gran, f"in.{name}")).read().split("run")[0]
        rows = {}
        for dev in ("cuda", "cpu"):
            b6.counts.reset()
            script = LammpsScript(device=dev, dtype=torch.float64)
            script.run_string(text)
            script.sim.verbose = False
            script.run_string("run 300")
            rows[dev] = dict(script.sim.last_thermo)
            if dev == "cuda":
                n = b6.counts.kernel_launches
                assert n > 300 and b6.counts.plain_calls == 0
                assert b6.counts.hertz_launches == (
                    n if name == "granhertz" else 0)
        assert rows["cuda"]["atoms"] == rows["cpu"]["atoms"]
        assert rows["cuda"]["ke"] == pytest.approx(rows["cpu"]["ke"],
                                                   rel=1e-9)


@pytest.mark.cuda
def test_gran_cuda_kernel_flags_contacts_past_kh():
    """Unit spheres on a bcc lattice of cube edge 0.97 touch 14 others:
    one step of gran/hertz/history on the card records 14 in the pair's
    hist_over, as the plain version does on the CPU, and warns once; on
    an fcc lattice of nearest distance 0.96 (12 touching) neither
    does."""
    _card()
    deck = """
units lj
atom_style sphere
boundary p p p
lattice {lat}
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
pair_style gran/hertz/history 2000.0 NULL 50.0 NULL 0.5 1
pair_coeff * *
fix 1 all nve/sphere
neighbor 0.3 bin
neigh_modify delay 0 every 1
timestep 0.0001
thermo 1
run 1
"""
    for lat, want in (("fcc 1.6", 0), ("bcc 2.2", 14)):
        for dev in ("cuda", "cpu"):
            b6.counts.reset()
            script = LammpsScript(device=dev, dtype=torch.float64)
            script.run_string(deck.format(lat=lat))
            sim = script.sim
            assert sim._ctx.is_cellgrid
            assert int(sim.pair.hist_over) == want
            warned = [ln for ln in sim.log_lines
                      if "lose shear history" in ln]
            assert len(warned) == (1 if want else 0)
            if dev == "cuda":
                assert b6.counts.kernel_launches >= 2
                assert b6.counts.plain_calls == 0


ANALYSIS_LJ = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 6 0 6 0 6
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 20 check no
fix             1 all nve
compute         pea all pe/atom
compute         str all stress/atom NULL
compute         rdf all rdf 50
compute         crd all coord/atom cutoff 1.5
compute         cls all cluster/atom 1.2
compute         cna all cna/atom 1.43
compute         cen all centro/atom fcc
compute         ori all orientorder/atom
"""


def _analysis_deck(device, mode, steps=30):
    s = LammpsScript(device=device, dtype=torch.float64)
    s.run_string(ANALYSIS_LJ)
    s.sim.neighbor_mode = mode
    s.sim.verbose = False
    s.run_string(f"run {steps}")
    return s.sim


@pytest.mark.cuda
def test_peratom_tallies_from_b1_slots_equal_the_matrix_plain_version():
    """pe/atom and stress/atom from B1's halved per-slot outputs (the
    per-atom variant, one launch) equal the matrix engine's plain
    pair_sums tallies on the CPU at the same state (in.lj at 6^3, f64,
    step 30)."""
    _card()
    card = _analysis_deck("cuda", "cellgrid")
    cpu = _analysis_deck("cpu", "matrix")
    n0 = b1.counts.peratom_launches
    for cid in ("pea", "str"):
        got = card.computes[cid](card).cpu().numpy()
        want = cpu.computes[cid](cpu).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())
    assert b1.counts.peratom_launches == n0 + 1


@pytest.mark.cuda
def test_peratom_tallies_from_b5_slots_equal_the_plain_version(tmp_path):
    """pe/atom and stress/atom of the water deck from B5's halved
    per-slot outputs equal B5's plain list sweep's on the CPU (charmm has
    no matrix path) at step 0, f64."""
    _card()
    gold = os.path.join(os.path.dirname(GOLDEN), "chunk_family")
    deck = open(os.path.join(gold, "in.chk")).read().split("compute")[0] \
        + "compute pea all pe/atom\ncompute str all stress/atom NULL\n" \
        + "run 0\n"
    import shutil
    shutil.copy(os.path.join(gold, "data.water"), tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        s = LammpsScript(device=dev, dtype=torch.float64)
        s.data_dir = str(tmp_path)
        s.run_string(deck)
        out[dev] = {c: s.sim.computes[c](s.sim).cpu().numpy()
                    for c in ("pea", "str")}
    for c in ("pea", "str"):
        np.testing.assert_allclose(out["cuda"][c], out["cpu"][c], rtol=0,
                                   atol=1e-10 * np.abs(out["cpu"][c]).max())


@pytest.mark.cuda
def test_distance_computes_over_the_list_kernel_equal_plain():
    """rdf, coord/atom, cluster/atom, cna/atom, centro/atom and
    orientorder/atom over the list kernel's occasional list equal their
    plain all-pairs versions on the card (integers exactly, rdf counts
    exactly, the rest to 1e-12)."""
    _card()
    sim = _analysis_deck("cuda", "cellgrid")
    n0 = bpl.counts.kernel_launches
    for cid in ("rdf", "crd", "cls", "cna", "cen", "ori"):
        c = sim.computes[cid]
        got = c(sim)
        c.plain = True
        try:
            plain = c.evaluate(sim)
            counts_plain = c.counts(sim) if cid == "rdf" else None
        finally:
            c.plain = False
        if cid in ("crd", "cls", "cna"):
            assert torch.equal(got, plain), cid
        elif cid == "rdf":
            assert torch.equal(c.counts(sim), counts_plain)
        else:
            torch.testing.assert_close(got, plain, rtol=1e-12, atol=1e-12)
    # one list for the state, at the largest cutoff, from the kernel
    assert bpl.counts.kernel_launches == n0 + 1
    assert sim.analysis_grid_lists >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kspace", ["pppm 1e-4", "ewald 1e-6"])
def test_salt_kspace_on_the_card_equals_the_cpu(kspace):
    """IN_SALT32K at 2x2x2 (512 ions, born/coul/long) on the matrix engine
    with kspace_style pppm or ewald: 20 steps on the card equal the CPU's
    to 1e-10 in f64, P1 launched on every force evaluation; and the eight
    pair goldens on the card agree with the reference binary's logs."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch import pair_goldens as pg
    from tpumd_torch.ops import gather
    _card()
    gold = os.path.dirname(GOLDEN)
    deck = bt.IN_SALT32K.format(golden=os.path.join(gold, "wolfdsf")).replace(
        "replicate       8 8 8", "replicate       2 2 2").replace(
        "pppm 1e-4", kspace).replace("thermo          100",
                                     "thermo          10")
    rows = {}
    for dev in ("cuda", "cpu"):
        gather.counts.reset()
        s = LammpsScript(device=dev, dtype=torch.float64)
        s.run_string(deck + "run 20")
        assert not s.sim._ctx.is_cellgrid
        if dev == "cuda":
            assert gather.counts.kernel_launches >= 21
            assert gather.counts.plain_calls == 0
        rows[dev] = [[float(v) for v in ln.split()] for ln in s.sim.log_lines
                     if ln.split() and ln.split()[0].isdigit()]
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-10,
                               atol=1e-12)
    for name in pg.DECKS:
        script = pg.run(gold, name, "cuda", torch.float64)
        assert pg.failures(gold, name, script) == []


@pytest.mark.cuda
@pytest.mark.parametrize("style", ["sw", "tersoff"])
def test_energy_style_forces_through_p1_equal_plain_gather(style, tmp_path,
                                                           monkeypatch):
    """An energy style's forces on the card with its neighbour rows
    gathered by P1 equal those with the rows gathered by the plain
    version: P1 writes outside autograd, and the j side of every term
    reaches the forces through the scatter, not through the gather.  The
    CPU's forces (plain gather) equal both to 1e-12."""
    _card()
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.models import pair_manybody
    pot = bt.write_potential(tmp_path, bt.MB32K_POTENTIAL[style])
    deck = bt.in_mb32k(style, pot, (4, 4, 4)) + (
        "displace_atoms all random 0.1 0.1 0.1 4711 units box\nrun 0\n")
    out = {}
    for dev in ("cuda", "cpu"):
        script = LammpsScript(device=dev, dtype=torch.float64)
        script.run_string(deck)
        sim = script.sim
        s, neigh = sim._carry[0], sim._carry[1]
        p1.counts.reset()
        f, e, _, v = sim.pair.compute(s.x, s.type, s.box, neigh.idx,
                                      neigh.sbits, None, None, True, True)
        if dev == "cuda":
            assert p1.counts.kernel_launches >= 1
            assert p1.counts.plain_calls == 0
            monkeypatch.setattr(pair_manybody, "gather_rows",
                                p1.gather_rows_plain)
            fp, ep, _, vp = sim.pair.compute(s.x, s.type, s.box, neigh.idx,
                                             neigh.sbits, None, None, True,
                                             True)
            monkeypatch.undo()
            scale = float(fp.abs().max())
            assert scale > 0.1
            assert float((f - fp).abs().max()) <= 1e-12 * scale
            assert float(e) == pytest.approx(float(ep), rel=1e-12)
            assert float((v - vp).abs().max()) <= 1e-12 * float(
                vp.abs().max())
        order = torch.argsort(s.tag)
        out[dev] = (f[order].cpu(), float(e))
    scale = float(out["cpu"][0].abs().max())
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) \
        <= 1e-12 * scale
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dpd", "tip4p"])
def test_row_gather_on_dpd_and_tip4p_rows_equals_plain(name, tmp_path):
    """P1 on the inputs that DPD's force (its packed (x, v, tag, type)
    rows) and TIP4P's (the rows of each water's tags, their positions,
    the (x, type, q) rows of both sums and the coefficient rows) give it,
    recorded through a run of tests/golden/dpd and tests/golden/tip4p on
    the card in f64, bit for bit against the plain gather; and the run
    launched P1 and never its plain version."""
    _card()
    from tpumd_torch import kspace_goldens as kg
    from tpumd_torch.models import base, pair_dpd, pair_tip4p
    from tpumd_torch.ops import pairwise
    gold = os.path.dirname(GOLDEN)
    seen = {}
    mods = (pair_dpd, pair_tip4p, pairwise, base)

    def record(table, idx):
        key = (table.dtype, tuple(table.shape), tuple(idx.shape))
        seen.setdefault(key, (table.clone(), idx.clone()))
        return p1.gather_rows(table, idx)
    for m in mods:
        m.gather_rows = record
    p1.counts.reset()
    try:
        kg.run(gold, name, str(tmp_path), "cuda", torch.float64, steps=10)
    finally:
        for m in mods:
            m.gather_rows = p1.gather_rows
    assert p1.counts.kernel_launches > 11 and p1.counts.plain_calls == 0
    widths = {t[1][1] for t in seen}
    assert (8 in widths) if name == "dpd" else {1, 3, 5} <= widths
    for table, idx in seen.values():
        assert torch.equal(p1.gather_rows(table, idx),
                           p1.gather_rows_plain(table, idx))


def _both_devices(deck, steps):
    """The deck's last row after steps in f64 on the card and on the CPU,
    and the card's launch counts of B1 and P1 (plain calls included)."""
    out = {}
    for dev in ("cpu", "cuda"):
        b1.counts.reset()
        p1.counts.reset()
        s = LammpsScript(device=dev, dtype=torch.float64)
        s.run_string(deck + f"run {steps}\n")
        out[dev] = (dict(s.sim.last_thermo), s)
    launches = (b1.counts.kernel_launches, p1.counts.kernel_launches,
                b1.counts.plain_calls + p1.counts.plain_calls)
    return out["cuda"], out["cpu"], launches


def _rows_close(a, b, rtol=1e-9):
    for k, w in b.items():
        assert a[k] == pytest.approx(w, rel=rtol, abs=1e-12), k


@pytest.mark.cuda
def test_kappa_deck_on_the_card(tmp_path):
    """IN_KAPPA32K at 5^3 cells in f64: the card's rows = the CPU's, B1
    launched and no plain call, the swaps moving f_2 on the card."""
    _card()
    from tpumd_torch.bench_targets import IN_KAPPA32K
    deck = IN_KAPPA32K.format(n=5, grid=tmp_path / "g", thermo=10)
    (card, script), (cpu, _), (nb1, _, plain) = _both_devices(deck, 50)
    assert script.sim._ctx.is_cellgrid and nb1 > 50 and plain == 0
    assert card["f_2"] > 0
    _rows_close(card, cpu)


@pytest.mark.cuda
def test_bondcreate_deck_on_the_card(tmp_path):
    """IN_BONDCREATE32K at 4^3 cells in f64: the card's bonds and rows =
    the CPU's, P1 launched and no plain call."""
    _card()
    from tpumd_torch.bench_targets import IN_BONDCREATE32K
    deck = IN_BONDCREATE32K.format(n=4, local=tmp_path / "l", thermo=5)
    (card, script), (cpu, cs), (_, np1, plain) = _both_devices(deck, 20)
    assert not script.sim._ctx.is_cellgrid and np1 > 20 and plain == 0
    bonds = [{tuple(sorted(b[1:])) for b in s.sim.live_topology("bond")
              .tolist()} for s in (script, cs)]
    assert bonds[0] == bonds[1] and len(bonds[0]) > 0
    _rows_close(card, cpu)


@pytest.mark.cuda
def test_respa_deck_on_the_card(tmp_path):
    """IN_CHAIN_RESPA32K on 2,000 beads in f64: the card's rows = the
    CPU's, P1 launched and no plain call."""
    _card()
    from tpumd_torch.bench_targets import IN_CHAIN_RESPA32K
    data = tmp_path / "data.chain"
    chain_data(str(data), natoms=2000, chain_len=50)
    deck = IN_CHAIN_RESPA32K.format(data=data, inner=2, thermo=10)
    (card, script), (cpu, _), (_, np1, plain) = _both_devices(deck, 20)
    assert script.sim._ctx.respa is not None and np1 > 20 and plain == 0
    _rows_close(card, cpu)


def _hyb_deck(tmp_path, n=2):
    from tpumd_torch.bench_targets import IN_HYB32K, hyb_cell
    data = tmp_path / "data.hyb"
    if not data.exists():
        hyb_cell(str(data))
    return IN_HYB32K.format(data=data, n=n, thermo=10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b1_special_on_the_hyb_grid_equals_plain(dtype, tmp_path):
    """B1's special-weighted variant over the hyb cell 2x2x2's list (the
    1-2, 1-3 and 1-4 pairs coded 1-3; weights (0, 0, 0.5) and (0, 1, 1)),
    every flag, against the plain list sweep (TOL_LIST) and the stencil
    oracle matching the special tags; its launches counted apart."""
    _card()
    script = LammpsScript(device="cuda", dtype=dtype)
    script.run_string(_hyb_deck(tmp_path) + "run 0\n")
    sim = script.sim
    assert sim._ctx.is_cellgrid and sim.state.special_tags is not None
    s, neigh, _ = sim._carry
    c = sim.pair.kernel_coeffs()
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    for w in ((0.0, 0.0, 0.5), (0.0, 1.0, 1.0)):
        oracle = b1.lj_cellgrid_plain(
            s.x.double(), neigh.valid, s.box.to(device="cuda",
                                                dtype=torch.float64),
            sim._neigh_cfg, c, 1, 1,
            special=(s.tag, s.special_tags, s.special_codes, w))
        for eflag, vflag in FLAGS:
            b1.counts.reset()
            fk, ek, wk = b1.lj_cellgrid(s.x, neigh.valid, s.box,
                                        sim._neigh_cfg, c, eflag, vflag,
                                        plist, special=w)
            assert b1.counts.special_launches == b1.counts.kernel_launches \
                == 1
            fp, ep, wp = b1.lj_pairlist_plain(s.x, s.box, c, eflag, vflag,
                                              *plist[:2], special=w)
            torch.cuda.synchronize()
            fmax = float(fp.abs().max())
            assert float((fk - fp).abs().max()) <= TOL_LIST[dtype] * fmax
            assert float((fk.double() - oracle[0]).abs().max()) \
                <= TOL[dtype] * fmax
            if eflag:
                assert float(ek) == pytest.approx(float(ep), rel=TOL[dtype])
                assert float(ek) == pytest.approx(float(oracle[1]),
                                                  rel=TOL[dtype])
            if vflag:
                assert torch.allclose(wk, wp, rtol=TOL[dtype],
                                      atol=TOL[dtype] * float(
                                          wp.abs().max()))


@pytest.mark.cuda
def test_hyb_and_ellipsoid_decks_on_the_card(tmp_path):
    """The hyb cell 2x2x2 on the grid (B1-special once per force
    evaluation, no plain call) and the 512-atom ellipsoid liquid, each 20
    steps in f64: the card's rows = the CPU's."""
    _card()
    from tpumd_torch.bench_targets import IN_ELLIPSOID, ellipsoid_data
    (card, script), (cpu, _), (nb1, _, plain) = _both_devices(
        _hyb_deck(tmp_path), 20)
    assert script.sim._ctx.is_cellgrid and plain == 0
    assert b1.counts.special_launches == nb1 > 20
    _rows_close(card, cpu)
    data = tmp_path / "data.ell"
    ellipsoid_data(str(data), 8)
    (card, script), (cpu, _), (nb1, _, plain) = _both_devices(
        IN_ELLIPSOID.format(data=data), 20)
    assert script.sim._ctx.is_cellgrid and nb1 > 20 and plain == 0
    assert script.sim.state.quat is not None
    _rows_close(card, cpu)


@pytest.mark.cuda
def test_rk_split_on_two_streams_equals_fused():
    """The peptide with the rhodo_class settings in f64 on the card: the
    r/k split (k-space on the side stream) = the fused evaluation to
    1e-11 of max|f|."""
    _card()
    from tpumd_torch.parallel import rkspace
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.run_string(IN_RHODO_CLASS.format(golden=GOLDEN).replace(
        "replicate       2 2 4\n", "") + "run 0\n")
    f_split, f_fused = rkspace.dryrun_rk_split(script.sim)
    torch.cuda.synchronize()
    side = rkspace.side_stream(f_split.device)
    assert side != torch.cuda.current_stream(f_split.device)
    scale = float(f_fused.abs().max())
    assert float((f_split - f_fused).abs().max()) <= 1e-11 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", [(4, 1), (2, 2)])
def test_local_grids_equal_the_global_launch(layout, dtype):
    """The list kernel and B1 on each rank's local grid of a decomposed
    8^3 in.lj grid (4^3 cells; 4 z-slabs or 2 x 2 pencils), assembled by
    index from the global grid with the halos' seam shift
    (``parallel/decomp.py``), the list built on the box whose split axes
    are not periodic: each owned row's list length equals its global
    row's and its forces equal the global launch's (f32 to 1e-6 of
    max|f|, f64 to 1e-13; they come out bit-equal), the halo rows'
    forces 0, and the owned rows' forces equal the plain list sweep's on
    the same local grid (f32 2e-6, f64 1e-13 of max|f|)."""
    _card()
    from tpumd_torch.parallel.decomp import GridLayout, assemble_slots
    x, valid, box, cfg, plist = _fcc_grid((8, 8, 8), dtype)
    tag = torch.zeros(cfg.capacity, dtype=torch.int32, device="cuda")
    tag[valid] = torch.arange(1, int(valid.sum()) + 1, dtype=torch.int32,
                              device="cuda")
    s = make_state(np.zeros((cfg.capacity, 3)), np.zeros((cfg.capacity, 3)),
                   np.ones(cfg.capacity, np.int32), box, device="cuda",
                   dtype=dtype).replace(x=x, tag=tag)
    eps, sig, cut = np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2))
    eps[1, 1], sig[1, 1], cut[1, 1] = 1.0, 1.0, 2.5
    c = pair_from_numpy(eps, sig, cut).kernel_coeffs()
    K = plist[0].shape[1]
    fg = b1.lj_cellgrid(x, valid, box, cfg, c, 0, 0, plist)[0]
    tol = {torch.float32: 1e-6, torch.float64: 1e-13}[dtype]
    # the same pairs in the same order as the plain list sweep (chip_smoke's
    # TOL_LIST)
    plain_tol = {torch.float32: 2e-6, torch.float64: 1e-13}[dtype]
    for rank in range(layout[0] * layout[1]):
        lay = GridLayout(cfg, *layout, rank)
        sl, vl = assemble_slots(lay, s, valid)
        gslot, _, own = (torch.as_tensor(a, device="cuda")
                         for a in lay.slot_maps)
        owned = vl & own
        rows = torch.nonzero(owned).reshape(-1)
        lbox = lay.list_box(box)
        pairs, npairs, _, over = bpl.cellgrid_pairlist(
            sl.x, vl, sl.tag, None, None, lbox, lay.local_cfg, K)
        assert not bool(over)
        f = b1.lj_cellgrid(sl.x, owned, box, lay.local_cfg, c, 0, 0,
                           (pairs, npairs, rows))[0]
        torch.cuda.synchronize()
        assert torch.equal(npairs[rows], plist[1][gslot[rows]])
        gap = float((f[rows] - fg[gslot[rows]]).abs().max())
        assert gap <= tol * float(fg.abs().max())
        assert not f[~owned].any()
        # and against its plain list sweep on the same local grid
        fp = b1.lj_pairlist_plain(sl.x, box, c, 0, 0, pairs, npairs,
                                  rows=rows)[0]
        err = float((f[rows] - fp[rows]).abs().max())
        assert err <= plain_tol * float(fp[rows].abs().max())
