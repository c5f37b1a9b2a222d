"""lj/cut over the cell grid's pair list (B1's plain list sweep), and the
list's refresh between re-bins, on the CPU.

In.lj's fcc lattice (rho* 0.8442, cutoff 2.5, cutneigh 2.8) binned into
the port's cell grid, the list built by the plain build as a re-bin
builds it, f64:

* "6cube": a 6^3 lattice (3^3 grid), each atom moved by up to 0.05 sigma
  per axis from a numpy seed (on the perfect lattice the forces cancel);
* "2x2x2": a 4^3 lattice, a 2^3 grid where every neighbour cell is met at
  two periodic images;
* "perturbed": a 6^3 lattice, each atom moved by up to 0.2 sigma.

* The plain list sweep equals the stencil oracle ``lj_cellgrid_plain``:
  forces to 1e-12 of max|f|, energy to 1e-12 relative, virial to 1e-12 of
  its largest component, with every energy/virial flag.
* In f32 on the 2x2x2 and perturbed grids, it equals tpumd's TPU kernel
  ``lj_cellgrid_forces_pallas`` run under
  ``pltpu.force_tpu_interpret_mode()`` to 5e-5 of max|f| (both sum ~55
  f32 terms per atom in different orders), as tests/test_torch_lj_kernel.py
  holds it on the 6x6x6 and 4x6x6 blocks.
* A stale list: one atom moved 0.45 sigma toward a partner at a sqrt(3)
  (2.909 sigma, beyond cutneigh) brings the pair within the cutoff; the
  list of the old positions misses it and its sweep differs from the
  oracle; ``refresh_pairlist`` rebuilds it in place (the move is past
  skin/2) and the sweep equals the oracle.  With no atom past skin/2 it
  leaves the list, its positions and its counts untouched; with the box
  corners kept, their move shrinks the trigger (LAMMPS's boxcheck).
* The 8^3 in.lj deck (2,048 atoms, re-bins every 20 steps unchecked) after
  39 steps, at the end of a window: the list the run carries, refreshed
  where stale, sweeps to the stencil oracle's forces (1e-12 of max|f|); a
  list kept from the re-bin alone misses pairs there (~6e-4 of max|f|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpumd.core.state import Box as JBox
from tpumd.ops import cellgrid as jcg
from tpumd.ops.pallas_lj import lj_cellgrid_forces_pallas
from tpumd_torch.bench_targets import IN_LJ
from tpumd_torch.core.create import create_atoms_lattice
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.state import Box, make_state, wrap_pbc
from tpumd_torch.interop import pair_from_numpy
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import lj_cellgrid as b1
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

CUTNEIGH, SKIN = 2.8, 0.3
# name: (lattice cells per axis, perturbation amplitude, seed)
CASES = {"6cube": (6, 0.05, 5), "2x2x2": (4, 0.05, 6),
         "perturbed": (6, 0.2, 7)}
FLAGS = ((1, 1), (0, 0), (1, 0), (0, 1))


def _coeffs():
    eps, sig, cut = np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2))
    eps[1, 1], sig[1, 1], cut[1, 1] = 1.0, 1.0, 2.5
    return pair_from_numpy(eps, sig, cut).kernel_coeffs()


def grid(n, amp, seed, lattice=("fcc", 0.8442, "lj"), cutneigh=CUTNEIGH,
         skin=SKIN, dtype=torch.float64):
    """(grid-ordered state, valid, box, grid config, the numpy lattice
    positions) of an n^3 lattice moved by up to amp per axis."""
    lat = Lattice(lattice[0], lattice[1], units=lattice[2])
    hi = np.full(3, n * lat.spacing)
    x0, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    x = x0 + np.random.default_rng(seed).uniform(-amp, amp, x0.shape)
    box = Box.orthogonal(np.zeros(3), hi, device="cpu", dtype=dtype)
    s = wrap_pbc(make_state(x, np.zeros_like(x), t, box, device="cpu",
                            dtype=dtype))
    cfg = cg.choose_cellgrid_config(box, cutneigh, skin, len(x))
    s = cg.pad_state(s, cfg.capacity)
    valid0 = torch.arange(cfg.capacity) < len(x)
    perm, valid, _, over = cg.bin_permutation(s.x, valid0, s.box, cfg)
    assert not bool(over)
    return cg.apply_permutation(s, perm, valid), valid, box, cfg


def build(s, valid, box, cfg, box_term=False):
    """The list a re-bin builds, with its hold and status words: (pairs,
    npairs, rows, stat, hold)."""
    natoms = int(valid.sum())
    stat = bpl.new_stat(s.x.device)
    hold = bpl.pairlist_hold(s.x, valid, s.tag, None, None, cfg,
                             box_term=box_term)
    pairs, npairs, _, over = bpl.cellgrid_pairlist(
        s.x, valid, s.tag, None, None, box, cfg,
        cg.pairlist_kmax(box, cfg.cutneigh, natoms), stat=stat, hold=hold)
    assert not bool(over)
    return pairs, npairs, cg.row2slot_from_tags(s.tag, natoms), stat, hold


def assert_same_sums(out, ref, rtol=1e-12):
    """Forces to rtol of max|f|, energy relative, virial of its largest."""
    fmax = float(ref[0].abs().max())
    assert fmax > 0.1
    assert float((out[0] - ref[0]).abs().max()) <= rtol * fmax
    for a, b in zip(out[1:], ref[1:]):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= rtol * float(b.abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_list_sweep_matches_stencil_oracle(case):
    s, valid, box, cfg = grid(*CASES[case])
    assert (min(cfg.nx, cfg.ny, cfg.nz) == 2) == (case == "2x2x2")
    pairs, npairs, rows, _, _ = build(s, valid, box, cfg)
    c = _coeffs()
    for ef, vf in FLAGS:
        n0 = b1.counts.plain_calls
        out = b1.lj_cellgrid(s.x, valid, box, cfg, c, ef, vf,
                             (pairs, npairs, rows))
        assert b1.counts.plain_calls == n0 + 1
        assert_same_sums(out, b1.lj_cellgrid_plain(s.x, valid, box, cfg, c,
                                                   ef, vf))
    with pytest.raises(ValueError, match="no pair list"):
        b1.lj_cellgrid(s.x, valid, box, cfg, c, 0, 0, None)


@pytest.mark.parametrize("case", ["2x2x2", "perturbed"])
def test_f32_list_sweep_matches_pallas_kernel(case):
    s, valid, box, cfg = grid(*CASES[case])
    pairs, npairs, rows, _, _ = build(s, valid, box, cfg)
    c = _coeffs()
    x32 = s.x.to(torch.float32)
    box32 = Box(lo=box.lo.float(), hi=box.hi.float())
    jbox = JBox.orthogonal(box.lo.numpy(), box.hi.numpy(), dtype=jnp.float32)
    jcfg = jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    with pltpu.force_tpu_interpret_mode():
        fj = np.asarray(lj_cellgrid_forces_pallas(
            jnp.asarray(x32.numpy()), jnp.asarray(valid.numpy()), jbox, jcfg,
            c.lj1, c.lj2, c.cutsq))
    ft, _, _ = b1.lj_cellgrid(x32, valid, box32, cfg, c, False, False,
                              (pairs, npairs, rows))
    assert ft.dtype == torch.float32
    fmax = np.abs(fj).max()
    assert fmax > 1.0
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=5e-5 * fmax)


def far_pair(s, valid, box, r_far):
    """(i, j) slots of a pair at r_far (to 1e-6) apart on the lattice."""
    x = s.x
    ok = torch.nonzero(valid).reshape(-1)
    i = int(ok[0])
    d = x[ok] - x[i]
    d = d - box.lengths * torch.round(d / box.lengths)
    r = d.norm(dim=1)
    j = int(ok[torch.nonzero((r - r_far).abs() < 1e-6)[0]])
    return i, j


def move_toward(s, i, j, box, dist):
    """s with slot j moved dist toward slot i (minimum image)."""
    d = s.x[i] - s.x[j]
    d = d - box.lengths * torch.round(d / box.lengths)
    x = s.x.clone()
    x[j] = x[j] + dist * d / d.norm()
    return s.replace(x=x)


def test_stale_list_misses_a_pair_until_refreshed():
    s, valid, box, cfg = grid(6, 0.0, 0)
    pairs, npairs, rows, stat, hold = build(s, valid, box, cfg)
    a = float(box.lengths[0]) / 6
    i, j = far_pair(s, valid, box, a * np.sqrt(3.0))
    assert a * np.sqrt(3.0) > CUTNEIGH
    moved = move_toward(s, i, j, box, 0.45)
    d = moved.x[i] - moved.x[j]
    assert float((d - box.lengths * torch.round(d / box.lengths)).norm()) \
        < 2.5
    c = _coeffs()
    oracle = b1.lj_cellgrid_plain(moved.x, valid, box, cfg, c, True, True)
    plist = (pairs, npairs, rows)
    stale = b1.lj_cellgrid(moved.x, valid, box, cfg, c, True, True, plist)
    fmax = float(oracle[0].abs().max())
    assert float((stale[0] - oracle[0]).abs().max()) > 1e-6 * fmax
    n0 = bpl.refresh_counts.plain_calls
    bpl.refresh_pairlist(moved.x, valid, box, cfg, pairs, npairs, stat,
                         hold)
    assert bpl.refresh_counts.plain_calls == n0 + 1
    assert int(stat[2]) == 1 and torch.equal(hold.x, moved.x)
    assert_same_sums(b1.lj_cellgrid(moved.x, valid, box, cfg, c, True, True,
                                    plist), oracle)
    fresh = bpl.cellgrid_pairlist_plain(moved.x, valid, s.tag, None, None,
                                        box, cfg, pairs.shape[1])
    assert torch.equal(pairs, fresh[0]) and torch.equal(npairs, fresh[1])


def test_refresh_with_a_clear_flag_leaves_the_list():
    s, valid, box, cfg = grid(*CASES["perturbed"])
    pairs, npairs, rows, stat, hold = build(s, valid, box, cfg)
    k = int(torch.nonzero(valid)[0])
    x = s.x.clone()
    x[k, 2] += 0.49 * SKIN      # within skin/2 of the build
    before = (pairs.clone(), npairs.clone(), hold.x.clone(), stat.clone())
    bpl.refresh_pairlist(x, valid, box, cfg, pairs, npairs, stat, hold)
    for a, b in zip((pairs, npairs, hold.x, stat), before):
        assert torch.equal(a, b)


def test_refresh_trigger_takes_the_box_move():
    """With the box corners kept, a corner moved by 0.25 sigma leaves a
    trigger of (skin - 0.25) / 2 = 0.025: an atom moved 0.05 refreshes the
    list; without them it does not."""
    s, valid, box, cfg = grid(*CASES["perturbed"])
    x = s.x.clone()
    k = int(torch.nonzero(valid)[0])
    x[k, 0] += 0.05
    hi = box.hi.clone()
    hi[2] += 0.25
    moved_box = Box(lo=box.lo, hi=hi)
    for box_term, refreshes in ((False, 0), (True, 1)):
        pairs, npairs, rows, stat, hold = build(s, valid, box, cfg, box_term)
        assert (hold.box is None) != box_term
        bpl.refresh_pairlist(x, valid, moved_box, cfg, pairs, npairs, stat,
                             hold)
        assert int(stat[2]) == refreshes
        if box_term:
            assert torch.equal(hold.box, torch.cat([moved_box.lo, hi]))


def test_in_lj_list_at_the_end_of_a_window_equals_the_stencil():
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(IN_LJ.format(n=8))
    sim = script.sim
    sim.verbose = False
    script.run_string("run 39")
    s, neigh, _ = sim._carry
    assert neigh.ago == 19 and sim.list_refreshes >= 1
    c = sim.pair.kernel_coeffs()
    args = (s.x, neigh.valid, s.box, sim._neigh_cfg, c, True, True)
    assert_same_sums(b1.lj_cellgrid(*args, (neigh.pairs, neigh.npairs,
                                            neigh.row2slot)),
                     b1.lj_cellgrid_plain(*args))
