"""Host modules of the chain slice against tpumd: exact equality.

RanMars (uniform, gaussian and the blocked ``fill``), read_data with
``build_special`` on a generated chain file, the remap into the box,
and FENE's per-pair force and energy.  The host modules run in float64
numpy in both packages with the same operation order, so they must agree
bit for bit (tolerance 0); FENE runs through torch and jax.numpy and must
agree to 1e-14 relative.  The chain generator is checked against the
properties its docstring promises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core import create as j_create
from tpumd.io import read_data as j_read_data
from tpumd.models.bonded import BondFENE as JBondFENE
from tpumd.utils import ranmars as j_ranmars
from tpumd_torch.bench_targets import chain_data
from tpumd_torch.core import create as t_create
from tpumd_torch.io import read_data as t_read_data
from tpumd_torch.models.bonded import BondFENE as TBondFENE
from tpumd_torch.utils import ranmars as t_ranmars


def case_ranmars_uniform_gaussian():
    for seed in (904297, 1, 12345, 900000000):
        j, t = j_ranmars.RanMars(seed), t_ranmars.RanMars(seed)
        ju = [j.uniform() for _ in range(300)]
        tu = [t.uniform() for _ in range(300)]
        assert ju == tu
        assert [j.gaussian() for _ in range(301)] == \
            [t.gaussian() for _ in range(301)]


def case_ranmars_fill():
    j, t = j_ranmars.RanMars(904297), t_ranmars.RanMars(904297)
    # blocks of every phase of the lag pointers, a scalar draw between
    for n in (1, 2, 31, 97, 98, 3 * 60, 1000, 96_001):
        np.testing.assert_array_equal(j.fill(n), t.fill(n))
        assert j.uniform() == t.uniform()
    # fill equals the same number of scalar draws
    a, b = t_ranmars.RanMars(77), t_ranmars.RanMars(77)
    np.testing.assert_array_equal(a.fill(5000),
                                  [b.uniform() for _ in range(5000)])
    with pytest.raises(ValueError):
        t_ranmars.RanMars(0)


def _data_file(tmp_path, natoms=500, chain_len=25):
    path = tmp_path / "data.chain"
    chain_data(path, natoms, chain_len)
    return str(path)


def case_read_data_and_special(tmp_path):
    path = _data_file(tmp_path)
    jd = j_read_data.read_data(path, "bond")
    td = t_read_data.read_data(path, "bond")
    for name in ("natoms", "nbonds", "natomtypes", "nbondtypes", "box_lo",
                 "box_hi", "masses", "x", "v", "types", "molecule", "image",
                 "bonds"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name),
                                      err_msg=name)
    js = j_read_data.build_special(jd.natoms, jd.bonds)
    ts = t_read_data.build_special(td.natoms, td.bonds)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b)
    assert ts[0].shape == (500, 6)   # 2 partners each at 1-2, 1-3, 1-4
    # the atomic style reads "id type x y z"; other sections raise
    atomic = tmp_path / "data.atomic"
    atomic.write_text("t\n\n2 atoms\n1 atom types\n0 3 xlo xhi\n0 3 ylo yhi"
                      "\n0 3 zlo zhi\n\nAtoms\n\n1 1 0.5 0.5 0.5\n"
                      "2 1 1.5 0.5 0.5 1 0 0\n")
    ta = t_read_data.read_data(str(atomic), "atomic")
    ja = j_read_data.read_data(str(atomic), "atomic")
    for name in ("x", "types", "image"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))
    assert ta.molecule is None
    angles = tmp_path / "data.angles"
    angles.write_text(atomic.read_text().replace(
        "1 atom types", "1 atom types\n1 angles"))
    with pytest.raises(NotImplementedError, match="angles"):
        t_read_data.read_data(str(angles), "atomic")
    pc = tmp_path / "data.pc"
    pc.write_text(atomic.read_text() + "\nPair Coeffs\n\n1 1.0 1.0\n")
    with pytest.raises(NotImplementedError, match="Pair Coeffs"):
        t_read_data.read_data(str(pc), "atomic")


def case_remap_host():
    x = np.random.default_rng(4).uniform(-25.0, 40.0, (300, 3))
    lo, hi = np.array([0.0, -1.0, 2.0]), np.array([10.0, 3.5, 7.25])
    for periodic in ((True, True, True), (True, False, True)):
        jx, tx = x.copy(), x.copy()
        ji = j_create.remap_host(jx, lo, hi, periodic)
        ti = t_create.remap_host(tx, lo, hi, periodic)
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(ji, ti)


def case_fene_pair_functions():
    j, t = JBondFENE(2), TBondFENE(2)
    for style in (j, t):
        style.coeff(1, 30.0, 1.5, 1.0, 1.0)
        style.coeff(2, 20.0, 1.3, 0.8, 0.9)
    rng = np.random.default_rng(8)
    # through the WCA switch, the FENE log and the 0.1 clamp past R0
    r2 = rng.uniform(0.6, 2.4, (64, 32))
    bt = rng.integers(1, 3, (64, 32)).astype(np.int32)
    for jname, tname in (("bond_fn", "bond_fn"),
                         ("kernel_bond_fn", "kernel_bond_fn")):
        jf, je = getattr(j, jname)(jnp.asarray(r2), jnp.asarray(bt))
        tf, te = getattr(t, tname)(torch.as_tensor(r2), torch.as_tensor(bt))
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-14)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-14)
    assert t.kernel_reach == j.kernel_reach == 1.5
    with pytest.raises(NotImplementedError, match="bond type"):
        t.kernel_coeffs()


def case_chain_generator(tmp_path):
    for natoms, chain_len in ((32000, 100), (500, 25), (60, 10)):
        path = _data_file(tmp_path, natoms, chain_len)
        d = t_read_data.read_data(path, "bond")
        L = d.box_hi[0]
        assert L == pytest.approx((natoms / 0.85) ** (1 / 3), rel=1e-15)
        assert d.nbonds == natoms - natoms // chain_len
        assert d.molecule.max() == natoms // chain_len
        b = d.bonds
        assert (b[:, 0] == 1).all() and (b[:, 2] == b[:, 1] + 1).all()
        assert (d.molecule[b[:, 1] - 1] == d.molecule[b[:, 2] - 1]).all()
        dx = d.x[b[:, 1] - 1] - d.x[b[:, 2] - 1]
        r = np.sqrt(np.sum((dx - L * np.round(dx / L)) ** 2, axis=1))
        assert 0.9 < r.min() and r.max() < 1.15 < 1.5
        assert ((d.x >= 0) & (d.x < L)).all()
        np.testing.assert_allclose(d.v.mean(axis=0), 0.0, atol=1e-15)
        assert np.sum(d.v ** 2) / (3 * natoms - 3) == pytest.approx(0.97)
        if natoms <= 500:
            dd = d.x[:, None] - d.x[None]
            rr = np.sqrt(np.sum((dd - L * np.round(dd / L)) ** 2, axis=-1))
            np.fill_diagonal(rr, L)
            assert rr.min() > 0.95    # no overlapping beads
    # the same seed makes the same file
    a, b = tmp_path / "a", tmp_path / "b"
    chain_data(a, 60, 10)
    chain_data(b, 60, 10)
    assert a.read_text() == b.read_text()


CASES = {k[5:]: v for k, v in globals().items() if k.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_host_matches_tpumd(case, tmp_path):
    fn = CASES[case]
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()
