"""The LJ cell-grid kernel module of the port against tpumd.

On the CPU the port's wrapper ``lj_cellgrid`` runs its plain PyTorch
version, the sweep of the grid's pair list (built here as a re-bin builds
it); these tests hold that version against tpumd:

* f32 forces against the TPU kernel's own body,
  ``lj_cellgrid_forces_pallas``, run under
  ``pltpu.force_tpu_interpret_mode()``: tolerance 5e-5 * max|f| (both sum
  ~1,000 f32 terms per atom in different orders; the f32 Pallas kernel
  sat at ~1e-5 of max|f| against float64 on these grids);
* f64 forces, energy and virial against tpumd's XLA sweep
  ``cellgrid_pair_sums`` with ``PairLJCut.pair_fn``, pair_modify shift
  on and off: forces 1e-12 * max|f|, energy and virial 1e-12 relative
  (summation order only).

Grids: the 6^3 in.lj deck (3x3x3 cells, cap 52) and a 4x6x6 block (nx = 2,
which pins the periodic +-1 offsets to one cell under two wrap
corrections).  Positions are perturbed by up to 0.05 sigma from a numpy
seed: on the perfect lattice the forces cancel to ~1e-13, below the f32
residue.  The CUDA kernel against the plain version, on the card, is in
tests/test_torch_cuda_kernels.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpumd.core.state import Box as JBox
from tpumd.models.pair_lj_cut import PairLJCut as JPairLJCut
from tpumd.ops import cellgrid as jcg
from tpumd.ops.pallas_lj import lj_cellgrid_forces_pallas
from tpumd_torch.core.create import create_atoms_lattice
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.state import Box, make_state, wrap_pbc
from tpumd_torch.interop import pair_from_numpy
from tpumd_torch.ops import cellgrid as tcg
from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist
from tpumd_torch.ops.lj_cellgrid import counts, lj_cellgrid

BLOCKS = {"6x6x6": (6, 6, 6), "4x6x6": (4, 6, 6)}

# the suite runs in several worker processes on shared cores: keep the
# plain torch sweeps from oversubscribing them
torch.set_num_threads(2)


def _grid(block, seed=5, device="cpu"):
    """Slot-ordered f64 positions, types, validity, box, grid, box corner
    and pair list (pairs, npairs, rows) of a perturbed fcc block; the
    port's binning (held equal to tpumd's elsewhere)."""
    lat = Lattice("fcc", 0.8442)
    hi = np.asarray(block) * lat.spacing
    x, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    x = x + np.random.default_rng(seed).uniform(-0.05, 0.05, x.shape)
    box = Box.orthogonal(np.zeros(3), hi, device=device,
                         dtype=torch.float64)
    s = wrap_pbc(make_state(x, np.zeros_like(x), t, box, device=device,
                            dtype=torch.float64))
    cfg = tcg.choose_cellgrid_config(box, 2.8, 0.3, len(x))
    s = tcg.pad_state(s, cfg.capacity)
    valid0 = torch.arange(cfg.capacity, device=device) < len(x)
    perm, valid, _, over = tcg.bin_permutation(s.x, valid0, s.box, cfg)
    assert not bool(over)
    s = tcg.apply_permutation(s, perm, valid)
    pairs, npairs, _, over = cellgrid_pairlist(
        s.x, valid, s.tag, None, None, box, cfg,
        tcg.pairlist_kmax(box, cfg.cutneigh, len(x)))
    assert not bool(over)
    plist = (pairs, npairs, tcg.row2slot_from_tags(s.tag, len(x)))
    return s.x, s.type, valid, box, cfg, hi, plist


def _pair_tables():
    eps, sig, cut = np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2))
    eps[1, 1], sig[1, 1], cut[1, 1] = 1.0, 1.0, 2.5
    return eps, sig, cut


def _pairs(shift: bool):
    tp = pair_from_numpy(*_pair_tables(), shift=shift)
    jp = JPairLJCut(1)
    jp.settings(2.5)
    jp.coeff(1, 1, 1, 1, 1.0, 1.0)
    jp.shift = shift
    jp.init()
    return jp, tp


def _jcfg(cfg):
    return jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_f32_plain_matches_pallas_kernel(block):
    x, _, valid, box, cfg, hi, plist = _grid(BLOCKS[block])
    assert cfg.nz >= 3 and (cfg.nx == 2) == (block == "4x6x6")
    jp, tp = _pairs(shift=False)
    c = tp.kernel_coeffs()
    x32 = x.to(torch.float32)
    jbox = JBox.orthogonal(np.zeros(3), hi, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        fj = np.asarray(lj_cellgrid_forces_pallas(
            jnp.asarray(x32.numpy()), jnp.asarray(valid.numpy()), jbox,
            _jcfg(cfg), c.lj1, c.lj2, c.cutsq))
    box32 = Box(lo=box.lo.float(), hi=box.hi.float())
    n0 = counts.plain_calls
    ft, _, _ = lj_cellgrid(x32, valid, box32, cfg, c, False, False, plist)
    assert counts.plain_calls == n0 + 1
    assert ft.dtype == torch.float32
    fmax = np.abs(fj).max()
    assert fmax > 1.0
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=5e-5 * fmax)


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "shift"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_f64_plain_matches_cellgrid_pair_sums(block, shift):
    x, type_, valid, box, cfg, hi, plist = _grid(BLOCKS[block])
    jp, tp = _pairs(shift)
    jbox = JBox.orthogonal(np.zeros(3), hi, dtype=jnp.float64)
    fj, ej, _, vj = jcg.cellgrid_pair_sums(
        jnp.asarray(x.numpy()), jnp.asarray(type_.numpy()),
        jnp.asarray(valid.numpy()), jbox, _jcfg(cfg), jp.pair_fn,
        True, True)
    ft, et, vt, eb = tp.compute_cellgrid(x, valid, box, cfg, True, True,
                                         plist=plist)
    assert eb is None
    fj, vj = np.asarray(fj), np.asarray(vj)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0,
                               atol=1e-12 * np.abs(fj).max())
    assert float(et) == pytest.approx(float(ej), rel=1e-12)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0,
                               atol=1e-12 * np.abs(vj).max())
    # force-only and single-flag calls return the same forces
    for ef, vf in ((False, False), (True, False), (False, True)):
        f2, e2, v2, _ = tp.compute_cellgrid(x, valid, box, cfg, ef, vf,
                                            plist=plist)
        np.testing.assert_array_equal(f2.numpy(), ft.numpy())
        assert (e2 is None) != ef and (v2 is None) != vf


def test_pair_fn_mixed_tables_match_tpumd():
    """Two types with mixing: coefficient tables and per-pair (fpair,
    evdwl) through a plain table read equal tpumd's select chain to
    1e-14 relative (same formula, same operation order)."""
    jp = JPairLJCut(2)
    jp.settings(2.5)
    jp.coeff(1, 1, 1, 1, 1.0, 1.0)
    jp.coeff(2, 2, 2, 2, 0.5, 1.2, 3.0)
    jp.mix = "arithmetic"
    jp.shift = True
    jp.init()
    eps, sig, cut = np.zeros((3, 3)), np.zeros((3, 3)), np.zeros((3, 3))
    for i in (1, 2):
        eps[i, i], sig[i, i], cut[i, i] = jp.epsilon[i, i], jp.sigma[i, i], \
            jp.cut[i, i]
    tp = pair_from_numpy(eps, sig, cut, shift=True, mix="arithmetic")
    tp._setflag[1, 2] = tp._setflag[2, 1] = False
    tp.init()
    for name in ("epsilon", "sigma", "cut", "lj1", "lj2", "lj3", "lj4",
                 "offset", "cutsq"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    rng = np.random.default_rng(2)
    r2 = rng.uniform(0.8, 10.0, (64, 16))
    ti = rng.integers(1, 3, (64, 1)).astype(np.int32)
    tj = rng.integers(1, 3, (1, 16)).astype(np.int32)
    fj, ej, _, _ = jp.pair_fn(jnp.asarray(r2), jnp.asarray(ti),
                              jnp.asarray(tj))
    ft, et = tp.pair_fn(torch.as_tensor(r2), torch.as_tensor(ti),
                        torch.as_tensor(tj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-14)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-14)
