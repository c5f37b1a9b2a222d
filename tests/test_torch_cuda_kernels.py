"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  The file imports torch and tpumd_torch only, so it
runs on a card host without JAX:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.

* LJ (B1, ``lj_cellgrid``): perturbed fcc blocks of 6x6x6 and 4x6x6 cells
  (3^3 and 2x3x3 grids);
* LJ+FENE (B2, ``lj_fene_cellgrid``): the grid-ordered state of generated
  chain decks after setup, on a 5^3 grid and on a 2^3 grid where bonds
  count at the minimum image;
* EAM density and force passes (B3 ``eam_rho_cellgrid``, B4
  ``eam_force_cellgrid``): perturbed fcc lattices of the generated Cu-like
  potential, 5^3 and 4^3 lattice cells (3^3 and 2^3 grids); both force
  passes take the plain density pass's F', and the density pass is held
  on rho, F' and the embedding energy;
* lj/charmm/coul/long (B5, ``charmm_cellgrid``): the grid-ordered state of
  the peptide deck with the rhodo_class settings after set-up (a 2^3 grid
  of cap 368, every neighbour cell met at two images) and of its 1x1x2
  replica (a 2x2x4 grid), special weights, charges and the kspace
  exclusion term included;
* gran/hooke/history (B6, ``gran_cellgrid``): the grid-ordered state of
  generated chute packs after 30 steps on the card, a 9x5x4 grid and a
  5x2x3 grid (y periodic with 2 cells), z non-periodic, with the deck's
  coefficients (dampflag 0, the frozen base's bit, the base-base
  exclusion) and with dampflag 1 and limit_damping, the history as it is
  and scaled by 40 (most contacts slip); forces, torques and the history
  tables after the sweep (tags equal), both shearupdate values;
* the row gather (P1, ``gather_rows``): bit for bit equal to its plain
  version for f32, f64 and int32 tables of widths 1, 5, 12, 16 and 128
  with (M,) and (M, K) indices up to the last row, and at misaligned
  row starts; the matrix engine on the card (lj/cut on a small triclinic
  box and the 480-sphere chute pack on matrix rows) equals the CPU's
  thermo to 1e-10 after 20 steps, with a launch of P1 per force
  evaluation and no plain call.

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
from tpumd_torch.ops import charmm_cellgrid as b5
from tpumd_torch.ops import eam_cellgrid as b34
from tpumd_torch.ops import gran_cellgrid as b6
from tpumd_torch.ops.cellgrid_gran import GranCoeffs
from tpumd_torch.ops import lj_cellgrid as b1
from tpumd_torch.ops import gather as p1
from tpumd_torch.ops import lj_fene_cellgrid as b2
from tpumd_torch.script.parser import LammpsScript

TOL = {torch.float32: 5e-5, torch.float64: 1e-12}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "peptide")
FLAGS = ((1, 1), (0, 0), (1, 0), (0, 1))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _fcc_grid(block, dtype, seed=5, lattice=("fcc", 0.8442, "lj"),
              amp=0.05, cutneigh=2.8, skin=0.3):
    """Slot-ordered positions, validity, box and grid of a perturbed
    lattice of block cells (in.lj's fcc by default)."""
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
    return cg.apply_permutation(s, perm, valid).x, valid, box, cfg


def _chain_grid(tmp_path, natoms, chain_len, dtype):
    path = tmp_path / f"data.chain.{natoms}"
    chain_data(path, natoms, chain_len)
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.run_string(IN_CHAIN.format(data=path))
    script.sim.verbose = False
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
    return (s.x.to(dtype), neigh.valid, s.tag, s.bond_tags, box,
            sim._neigh_cfg, sim.pair.kernel_coeffs(),
            sim._ctx.kernel_bond.kernel_coeffs())


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
    """B1, the LJ cell-grid kernel."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    eps, sig, cut = np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2))
    eps[1, 1], sig[1, 1], cut[1, 1] = 1.0, 1.0, 2.5
    c = pair_from_numpy(eps, sig, cut).kernel_coeffs()
    for block in ((6, 6, 6), (4, 6, 6)):
        x, valid, box, cfg = _fcc_grid(block, dt)
        for ef, vf in FLAGS:
            n0 = b1.counts.kernel_launches
            out = b1.lj_cellgrid(x, valid, box, cfg, c, ef, vf)
            assert b1.counts.kernel_launches == n0 + 1
            _close(out, b1.lj_cellgrid_plain(x, valid, box, cfg, c, ef, vf),
                   TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_lj_fene_cuda_kernel_matches_plain(dtype, tmp_path):
    """B2, the LJ+FENE cell-grid kernel."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    for natoms, chain_len in ((500, 25), (60, 10)):
        args = _chain_grid(tmp_path, natoms, chain_len, dt)
        for ef, vf in FLAGS:
            n0 = b2.counts.kernel_launches
            out = b2.lj_fene_cellgrid(*args, ef, vf)
            assert b2.counts.kernel_launches == n0 + 1
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
    for nlat in (5, 4):
        x, valid, box, cfg = _fcc_grid(
            (nlat,) * 3, dt, lattice=("fcc", EAM_A0, "metal"), amp=0.15,
            cutneigh=pair.cutmax + 1.0, skin=1.0)
        assert cfg.nx == nlat - 2
        tab = pair.kernel_tables(x)
        for ef, vf in FLAGS:
            n0 = b34.rho_counts.kernel_launches
            rho = b34.eam_rho_cellgrid(x, valid, box, cfg, tab, ef)
            assert b34.rho_counts.kernel_launches == n0 + 1
            plain = b34.eam_rho_cellgrid_plain(x, valid, box, cfg, tab, ef)
            _close(rho, plain, TOL[dt])
            # F' of empty slots is 0 in both
            assert float(rho[1][~valid].abs().max()) == 0.0
            n0 = b34.force_counts.kernel_launches
            out = b34.eam_force_cellgrid(x, valid, plain[1], box, cfg, tab,
                                         ef, vf)
            assert b34.force_counts.kernel_launches == n0 + 1
            _close(out, b34.eam_force_cellgrid_plain(
                x, valid, plain[1], box, cfg, tab, ef, vf), TOL[dt])


def _charmm_grid(replicate, dtype):
    """The arguments of charmm_cellgrid for the rhodo_class deck on the
    peptide, replicated as given, after set-up on the card."""
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.run_string(IN_RHODO_CLASS.format(golden=GOLDEN).replace(
        "replicate       2 2 4", f"replicate       {replicate}"))
    script.sim.verbose = False
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    x = s.x.to(dtype)
    box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
    c = sim.pair.kernel_coeffs(x, *sim._special_weights())
    return (x, s.q.to(dtype), s.type, neigh.valid, s.tag, s.special_tags,
            s.special_codes, box, sim._neigh_cfg, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_charmm_cuda_kernel_matches_plain(dtype):
    """B5, the lj/charmm/coul/long cell-grid kernel."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    for replicate, grid in (("1 1 1", (2, 2, 2)), ("1 1 2", (2, 2, 4))):
        args = _charmm_grid(replicate, dt)
        cfg = args[8]
        assert (cfg.nx, cfg.ny, cfg.nz) == grid
        for ef, vf in FLAGS:
            n0 = b5.counts.kernel_launches
            out = b5.charmm_cellgrid(*args, ef, vf)
            assert b5.counts.kernel_launches == n0 + 1
            _close(out, b5.charmm_cellgrid_plain(*args, ef, vf), TOL[dt])



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
    coeffs = (c, c._replace(gammat=0.5 * c.gamman, limit_damping=True))
    return [((f(s.x), s.tag, neigh.valid, neigh.shear_tags,
              f(neigh.shear * k), box, sim._neigh_cfg), planes, coeffs)
            for k in (1.0, 40.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_gran_cuda_kernel_matches_plain(dtype, tmp_path):
    """B6, the gran/hooke/history cell-grid kernel."""
    _card()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    # every axis of 3 cells or more; y periodic with 2 cells; z
    # non-periodic with 2 cells (the aliased offsets dropped)
    for dims, grid in (((10, 6, 8), (9, 5, 4)), ((6, 3, 6), (5, 2, 3)),
                       ((6, 6, 4), (5, 5, 2))):
        for args, planes, coeffs in _gran_grid(tmp_path, dims, dt):
            cfg = args[6]
            assert (cfg.nx, cfg.ny, cfg.nz) == grid
            for c in coeffs:
                assert isinstance(c, GranCoeffs)
                for shearupdate in (True, False):
                    n0 = b6.counts.kernel_launches
                    out = b6.gran_cellgrid(*args, c, planes, 1e-4,
                                           shearupdate)
                    assert b6.counts.kernel_launches == n0 + 1
                    plain = b6.gran_compact_sums(
                        *args, c, planes, 1e-4, shearupdate)
                    torch.cuda.synchronize()
                    assert torch.equal(out[2], plain[2])
                    for k, p in zip(out[:2] + out[3:], plain[:2] + plain[3:]):
                        assert float((k - p).abs().max()) <= TOL[dt] * float(
                            p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64", "i32"])
def test_row_gather_cuda_kernel_equals_plain(dtype):
    """P1, the row gather: a copy, so bit for bit."""
    _card()
    rng = np.random.default_rng(3)
    for width in (1, 5, 12, 16, 128):
        rows = 1000
        if dtype == "i32":
            table = torch.as_tensor(rng.integers(-2**31, 2**31 - 1,
                                                 (rows, width)),
                                    dtype=torch.int32, device="cuda")
        else:
            table = torch.as_tensor(
                rng.standard_normal((rows, width)), device="cuda",
                dtype={"f32": torch.float32, "f64": torch.float64}[dtype])
        for shape in ((4099,), (517, 13)):
            idx = torch.as_tensor(rng.integers(0, rows, shape),
                                  dtype=torch.int32, device="cuda")
            idx.view(-1)[-1] = rows - 1
            n0 = p1.counts.kernel_launches
            out = p1.gather_rows(table, idx)
            assert p1.counts.kernel_launches == n0 + 1
            torch.cuda.synchronize()
            assert torch.equal(out, p1.gather_rows_plain(table, idx))
        # a table starting one element past an aligned address takes
        # 4- or 8-byte copies
        shifted = table.view(-1)[1:1 + (rows - 1) * width].view(rows - 1,
                                                                width)
        idx = torch.arange(rows - 2, -1, -1, dtype=torch.int32,
                           device="cuda")
        assert torch.equal(p1.gather_rows(shifted, idx),
                           p1.gather_rows_plain(shifted, idx))


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
