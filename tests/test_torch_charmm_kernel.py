"""The lj/charmm/coul/long cell-grid kernel module of the port against tpumd.

On the CPU the wrapper ``charmm_cellgrid`` runs its plain PyTorch version;
these tests hold it against tpumd on a synthetic charged system binned
into the port's cell grid: a jittered simple-cubic lattice of 216 atoms
(spacing 1.5 in a 9.0 box, +-0.25 per axis), 3 atom types with distinct
LJ coefficients, random charges, lj/charmm/coul/long 2.0 2.5 with
g_ewald 0.9 in real units, and special lists of width 4 from a numpy seed
(partners within the cutoff, codes 1-3 whose lj and coul weights differ,
so weight-0, partial and the kspace exclusion correction all occur).  The
grid is 3x3x3 cells of 3.0 (cutneigh 2.5 + 0.5), cap 16.

Both plain versions are held to tpumd: the wrapper ``charmm_cellgrid``
(on the CPU the plain sweep of the grid's pair list, built by the plain
``cellgrid_pairlist`` at a K sized from the density) and the stencil
oracle ``charmm_cellgrid_plain``:

* f32: against the TPU kernel ``charmm_cellgrid_forces_pallas`` under
  ``pltpu.force_tpu_interpret_mode()``: forces to 5e-5 of max|f|, the
  virial to 5e-5 of its largest component (f32 sums in another order).
* f64: against tpumd's XLA sweep
  ``cellgrid_pair_sums(q=..., special=..., pair_fn_ex=...)`` with
  ``PairLJCharmmCoulLong.pair_fn_ex``: forces, both energies and the
  virial to 1e-12 (summation order only), in every flag combination.

The CUDA kernel against the plain version, on the card, is in
tests/test_torch_cuda_kernels.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpumd.core.state import Box as JBox
from tpumd.models.pair_charmm import PairLJCharmmCoulLong as JPair
from tpumd.ops import cellgrid as jcg
from tpumd.ops.pallas_charmm import charmm_cellgrid_forces_pallas
from tpumd.utils.units import get_units as j_units
from tpumd_torch.core.state import Box, make_state, wrap_pbc
from tpumd_torch.interop import charmm_from_numpy
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import charmm_cellgrid as b5

torch.set_num_threads(2)

L, SPACING, JITTER = 9.0, 1.5, 0.25
CUT_INNER, CUT, SKIN, G_EWALD = 2.0, 2.5, 0.5, 0.9
W_LJ = (1.0, 0.0, 0.5, 0.7)      # by code 0..3
W_COUL = (1.0, 0.0, 0.3, 0.8)
EPS = np.array([0.0, 0.15, 0.08, 0.3])
SIG = np.array([0.0, 1.3, 1.1, 1.6])


def _tables():
    """(eps, sigma, eps14, sigma14) (4, 4) tables, arithmetic mixing."""
    eps = np.sqrt(np.outer(EPS, EPS))
    sig = 0.5 * (SIG[:, None] + SIG[None, :])
    return eps, sig, 0.5 * eps, sig


def _system(dtype, seed=21):
    rng = np.random.default_rng(seed)
    g = (np.arange(int(L / SPACING)) + 0.5) * SPACING
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    x = x + rng.uniform(-JITTER, JITTER, x.shape)
    n = len(x)
    types = rng.integers(1, 4, n).astype(np.int32)
    q = rng.uniform(-0.6, 0.6, n)
    q -= q.mean()
    # special lists: up to 4 partners within the cutoff, codes 1..3
    d = x[:, None, :] - x[None, :, :]
    d -= L * np.round(d / L)
    r = np.sqrt((d * d).sum(-1))
    np.fill_diagonal(r, np.inf)
    stags = np.zeros((n, 4), np.int32)
    scodes = np.zeros((n, 4), np.int32)
    for i in range(n):
        near = np.nonzero(r[i] < CUT)[0]
        pick = rng.choice(near, size=min(len(near), rng.integers(1, 5)),
                          replace=False)
        stags[i, :len(pick)] = pick + 1
        scodes[i, :len(pick)] = rng.integers(1, 4, len(pick))
    box = Box.orthogonal(np.zeros(3), np.full(3, L), device="cpu",
                         dtype=dtype)
    s = make_state(x, np.zeros_like(x), types, box, q=q, device="cpu",
                   dtype=dtype)
    s = s.replace(special_tags=torch.as_tensor(stags),
                  special_codes=torch.as_tensor(scodes))
    cfg = cg.choose_cellgrid_config(box, CUT + SKIN, SKIN, n)
    s = cg.pad_state(wrap_pbc(s), cfg.capacity)
    valid0 = torch.arange(cfg.capacity) < n
    perm, valid, _, over = cg.bin_permutation(s.x, valid0, s.box, cfg)
    assert not bool(over)
    return cg.apply_permutation(s, perm, valid), valid, box, cfg


def _pairs(dtype):
    eps, sig, e14, s14 = _tables()
    tp = charmm_from_numpy(eps, sig, e14, s14, CUT_INNER, CUT, CUT,
                           G_EWALD, "real")
    jp = JPair(3)
    jp.units = j_units("real")
    jp.settings(CUT_INNER, CUT, CUT)
    jp.epsilon, jp.sigma, jp.eps14, jp.sigma14 = (
        np.array(a) for a in (eps, sig, e14, s14))
    jp._setflag[1:, 1:] = True
    jp.init()
    jp.g_ewald = G_EWALD
    return tp, jp, tp.kernel_coeffs(torch.zeros((), dtype=dtype), W_LJ,
                                    W_COUL)


def _args(s, valid, box, cfg, c):
    return (s.x, s.q, s.type, valid, s.tag, s.special_tags, s.special_codes,
            box, cfg, c)


def _sweep(path, s, valid, box, cfg, c, eflag, vflag):
    """The charmm sweep by path: "list", the wrapper over the plain
    build's pair list (one plain call of each), or "stencil", the
    oracle."""
    if path == "stencil":
        return b5.charmm_cellgrid_plain(*_args(s, valid, box, cfg, c),
                                        eflag, vflag)
    kmax = cg.pairlist_kmax(box, cfg.cutneigh, int(valid.sum()))
    n0, m0 = b5.counts.plain_calls, bpl.counts.plain_calls
    pairs, npairs, _, over = bpl.cellgrid_pairlist(
        s.x, valid, s.tag, s.special_tags, s.special_codes, box, cfg, kmax)
    assert not bool(over)
    out = b5.charmm_cellgrid(s.x, s.q, s.type, pairs, npairs, box, cfg, c,
                             eflag, vflag)
    assert (b5.counts.plain_calls, bpl.counts.plain_calls) == (n0 + 1,
                                                               m0 + 1)
    return out


def _jax_inputs(s, valid, box, cfg, dtype):
    w = [np.asarray(tab)[s.special_codes.numpy()] for tab in (W_LJ, W_COUL)]
    jbox = JBox.orthogonal(box.lo.numpy(), box.hi.numpy(), dtype=dtype)
    jcfg = jcg.CellGridConfig(cutneigh=cfg.cutneigh, skin=cfg.skin,
                              nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, cap=cfg.cap)
    return (jnp.asarray(s.x.numpy()), jnp.asarray(s.q.numpy()),
            jnp.asarray(s.type.numpy()), jnp.asarray(s.tag.numpy()),
            jnp.asarray(valid.numpy()), jnp.asarray(s.special_tags.numpy()),
            jnp.asarray(w[0], dtype), jnp.asarray(w[1], dtype), jbox, jcfg)


@pytest.mark.parametrize("path", ["list", "stencil"])
def test_f32_plain_matches_pallas_kernel(path):
    s, valid, box, cfg = _system(torch.float32)
    assert (cfg.nx, cfg.ny, cfg.nz, cfg.cap) == (3, 3, 3, 16)
    tp, jp, c = _pairs(torch.float32)
    f, evdwl, ecoul, virial = _sweep(path, s, valid, box, cfg, c, False,
                                     True)
    assert evdwl is None and ecoul is None
    x, q, t, tag, v, st, swl, swc, jbox, jcfg = _jax_inputs(
        s, valid, box, cfg, jnp.float32)
    tables = jnp.stack([jnp.asarray(a, jnp.float32)
                        for a in (jp.lj1, jp.lj2, jp.lj3, jp.lj4)])
    with pltpu.force_tpu_interpret_mode():
        fj, vj = charmm_cellgrid_forces_pallas(
            x, q, t, tag, v, st, swl, swc, jbox, jcfg, tables,
            float(jp.units.qqr2e), float(jp.g_ewald), float(jp.cut_coulsq),
            float(jp.cut_ljsq), float(jp.cut_lj_innersq),
            float(jp.denom_lj), int(jp.ntypes))
    fj, vj = np.asarray(fj), np.asarray(vj)
    fmax = np.abs(fj).max()
    assert fmax > 10.0
    np.testing.assert_allclose(f.numpy(), fj, rtol=0, atol=5e-5 * fmax)
    np.testing.assert_allclose(virial.numpy(), vj, rtol=0,
                               atol=5e-5 * np.abs(vj).max())


def test_pair_fn_ex_matches_tpumd():
    """The plain pair function on random pairs through both cutoffs, the
    switching shell and every weight."""
    tp, jp, _ = _pairs(torch.float64)
    rng = np.random.default_rng(4)
    n = 4096
    r2 = rng.uniform(0.6, 7.0, n)
    ti, tj = (rng.integers(1, 4, n).astype(np.int32) for _ in range(2))
    wl, wc = (rng.choice([0.0, 0.5, 1.0], n) for _ in range(2))
    qi, qj = (rng.uniform(-0.6, 0.6, n) for _ in range(2))
    out = tp.pair_fn_ex(*(torch.as_tensor(a) for a in (r2, ti, tj, wl, wc,
                                                       qi, qj)))
    ref = jp.pair_fn_ex(*(jnp.asarray(a) for a in (r2, ti, tj, wl, wc, qi,
                                                   qj)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-13 * np.abs(np.asarray(b)).max())
    inside = r2 < CUT * CUT
    assert (out[0].numpy()[~inside] == 0).all()
    assert (out[2].numpy()[inside] != 0).all()


@pytest.mark.parametrize("path", ["list", "stencil"])
@pytest.mark.parametrize("flags", [(1, 1), (0, 0), (1, 0), (0, 1)])
def test_f64_plain_matches_cellgrid_pair_sums(flags, path):
    eflag, vflag = flags
    s, valid, box, cfg = _system(torch.float64)
    tp, jp, c = _pairs(torch.float64)
    f, evdwl, ecoul, virial = _sweep(path, s, valid, box, cfg, c, eflag,
                                     vflag)
    x, q, t, tag, v, st, swl, swc, jbox, jcfg = _jax_inputs(
        s, valid, box, cfg, jnp.float64)
    fj, ej, ecj, vj = jcg.cellgrid_pair_sums(
        x, t, v, jbox, jcfg, None, True, True, special=(tag, st, swl, swc),
        q=q, pair_fn_ex=jp.pair_fn_ex)
    fj = np.asarray(fj)
    fmax = np.abs(fj).max()
    np.testing.assert_allclose(f.numpy(), fj, rtol=0, atol=1e-12 * fmax)
    assert (evdwl is None, ecoul is None, virial is None) == (
        not eflag, not eflag, not vflag)
    if eflag:
        assert float(evdwl) == pytest.approx(float(ej), rel=1e-12)
        assert float(ecoul) == pytest.approx(float(ecj), rel=1e-12)
        assert float(ej) != 0.0 and float(ecj) != 0.0
    if vflag:
        vj = np.asarray(vj)
        np.testing.assert_allclose(virial.numpy(), vj, rtol=0,
                                   atol=1e-12 * np.abs(vj).max())
