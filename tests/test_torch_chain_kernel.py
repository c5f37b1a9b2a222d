"""The LJ+FENE cell-grid kernel module of the port against tpumd.

On the CPU the port's wrapper ``lj_fene_cellgrid`` runs its plain
PyTorch version, the sweep of the grid's pair list that the set-up
built; these tests hold that version against tpumd on the grid-ordered
state of a generated chain deck after setup:

* f32 forces against the TPU kernel's own body,
  ``lj_fene_cellgrid_forces_pallas``, run under
  ``pltpu.force_tpu_interpret_mode()`` on the 5^3 grid (it needs nz >= 3):
  tolerance 5e-5 * max|f| (both sum a few hundred f32 terms per atom in
  different orders, as for the LJ kernel);
* f64 forces, lj and bond energies and virial against tpumd's XLA sweep
  ``cellgrid_pair_sums(bond=...)`` with ``PairLJCut.pair_fn`` and
  ``BondFENE.kernel_bond_fn``, on the 5^3 grid and on a 2^3 grid where
  every partner is met at two periodic images and counts only at the
  minimum one: forces 1e-12 * max|f|, energies and virial 1e-12 relative
  (summation order only).

The CUDA kernel against the plain version, on the card, is in
tests/test_torch_cuda_kernels.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpumd.core.state import Box as JBox
from tpumd.models.bonded import BondFENE as JBondFENE
from tpumd.models.pair_lj_cut import PairLJCut as JPairLJCut
from tpumd.ops import cellgrid as jcg
from tpumd.ops.pallas_lj import lj_fene_cellgrid_forces_pallas
from tpumd_torch.bench_targets import IN_CHAIN, chain_data
from tpumd_torch.core.state import Box
from tpumd_torch.ops.cellgrid import cellgrid_pair_sums
from tpumd_torch.ops.lj_cellgrid import lj_pair_fn
from tpumd_torch.ops.lj_fene_cellgrid import counts, lj_fene_cellgrid
from tpumd_torch.script.parser import LammpsScript

# the suite runs in several worker processes on shared cores: keep the
# plain torch sweeps from oversubscribing them
torch.set_num_threads(2)

# (natoms, chain_len) -> 5x5x5 and 2x2x2 cells
GRIDS = {"5cube": (500, 25), "2cube": (60, 10)}


def _chain_grid(tmp_path, grid):
    """The grid-ordered f64 state of the chain deck after setup, and the
    kernel's coefficients and pair list."""
    path = tmp_path / "data.chain"
    chain_data(path, *GRIDS[grid])
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(IN_CHAIN.format(data=path))
    sim = script.sim
    sim.verbose = False
    script.run_string("run 0")
    s, neigh, _ = sim._carry
    lj = sim.pair.kernel_coeffs()
    fene = sim._ctx.kernel_bond.kernel_coeffs()
    plist = (neigh.pairs, neigh.npairs, neigh.bond_slots, neigh.row2slot)
    return s, neigh.valid, sim._neigh_cfg, lj, fene, plist


def _jcfg(cfg):
    return jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)


def _jnp(t):
    return jnp.asarray(t.cpu().numpy())


def test_f32_plain_matches_pallas_kernel(tmp_path):
    s, valid, cfg, lj, fene, plist = _chain_grid(tmp_path, "5cube")
    assert min(cfg.nx, cfg.ny, cfg.nz) >= 3
    btags = s.bond_tags
    assert btags.shape[1] == 2
    x32 = s.x.to(torch.float32)
    lo, hi = s.box.lo.numpy(), s.box.hi.numpy()
    jbox = JBox.orthogonal(lo, hi, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        fj = np.asarray(lj_fene_cellgrid_forces_pallas(
            _jnp(x32), _jnp(valid), _jnp(s.tag), _jnp(btags[:, 0]),
            _jnp(btags[:, 1]), jbox, _jcfg(cfg), lj.lj1, lj.lj2, lj.cutsq,
            tuple(fene)))
    box32 = Box(lo=s.box.lo.float(), hi=s.box.hi.float())
    n0 = counts.plain_calls
    ft, _, _, _ = lj_fene_cellgrid(x32, valid, box32, cfg, lj, fene, False,
                                   False, plist)
    assert counts.plain_calls == n0 + 1
    assert ft.dtype == torch.float32
    fmax = np.abs(fj).max()
    assert fmax > 10.0
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=5e-5 * fmax)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_f64_plain_matches_cellgrid_pair_sums(grid, tmp_path):
    s, valid, cfg, lj, fene, plist = _chain_grid(tmp_path, grid)
    assert (min(cfg.nx, cfg.ny, cfg.nz) < 3) == (grid == "2cube")
    jp = JPairLJCut(1)
    jp.settings(1.12)
    jp.coeff(1, 1, 1, 1, 1.0, 1.0)
    jp.shift = True
    jp.init()
    jb = JBondFENE(1)
    jb.coeff(1, 30.0, 1.5, 1.0, 1.0)
    jbox = JBox.orthogonal(s.box.lo.numpy(), s.box.hi.numpy(),
                           dtype=jnp.float64)
    fj, ej, _, vj, ebj = jcg.cellgrid_pair_sums(
        _jnp(s.x), _jnp(s.type), _jnp(valid), jbox, _jcfg(cfg), jp.pair_fn,
        True, True, bond=(_jnp(s.bond_tags), _jnp(s.bond_btypes),
                          jb.kernel_bond_fn, _jnp(s.tag), True))
    ft, et, vt, ebt = lj_fene_cellgrid(s.x, valid, s.box, cfg, lj, fene,
                                       True, True, plist)
    fj, vj = np.asarray(fj), np.asarray(vj)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0,
                               atol=1e-12 * np.abs(fj).max())
    assert float(et) == pytest.approx(float(ej), rel=1e-12)
    assert float(ebt) == pytest.approx(float(ebj), rel=1e-12)
    assert float(ebt) > 10 * abs(float(et))
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0,
                               atol=1e-12 * np.abs(vj).max())
    # force-only and single-flag calls return the same forces
    for ef, vf in ((False, False), (True, False), (False, True)):
        f2, e2, v2, eb2 = lj_fene_cellgrid(s.x, valid, s.box, cfg, lj,
                                           fene, ef, vf, plist)
        np.testing.assert_array_equal(f2.numpy(), ft.numpy())
        assert (e2 is None) != ef and (eb2 is None) != ef
        assert (v2 is None) != vf


def test_minimum_image_guard_matters(tmp_path):
    """On the 2^3 grid each partner is also met at a non-minimum image; a
    sweep that let the bond count there too would double the bond
    energy.  The guard keeps the per-bond count at one per direction."""
    s, valid, cfg, lj, fene, _ = _chain_grid(tmp_path, "2cube")

    def count(r2, btype):
        return torch.zeros_like(r2), torch.ones_like(r2)
    _, _, _, nbond = cellgrid_pair_sums(
        s.x, None, valid, s.box, cfg, lj_pair_fn(lj), True, False,
        bond=(s.bond_tags, s.bond_btypes, count, s.tag))
    # 1/2 per ordered pair: the count of bonds
    assert float(nbond) == 54.0
