"""The rhodo_class slice's host modules: the port against tpumd.

On LAMMPS's solvated peptide example (tests/golden/peptide/data.peptide,
2,004 atoms) with the rhodo_class deck's settings, float64 numpy or torch
on the CPU in both packages:

* read_data for atom_style full (charges, molecules, image flags, the
  four topologies and the coefficient sections): equal arrays;
* replicate (1x1x2 and 2x1x1): tags, molecules, charges, types, unwrapped
  positions, velocities, topology and special lists equal;
* special_bonds: the lj and coul weights of each preset, and
  build_special's 1-2/1-3/1-4 lists and codes;
* lj/charmm/coul/long's arithmetic mixing, the lj1..lj4 and 1-4 tables;
* each bonded style (bond harmonic, angle charmm, dihedral charmm with its
  1-4 pairs, improper harmonic) on the peptide topology: forces to 1e-12
  of max|f|, every energy it tallies and the virial to 1e-12 (the port
  evaluates each tuple once, tpumd once per member atom; summation order
  only);
* SHAKE's cluster selection (mass 1.0 and angle type 31), the constrained
  bond and angle rows and the removed degrees of freedom;
* fix nvt/npt parsing and the real units;
* the barostat's re-validation of the cell grid (port only): a box whose
  cells shrank below cutneigh is re-binned with a wider margin, every
  per-atom field following its atom, and the new grid's pair list built;
  one below 2 cutneigh raises.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.core.state import make_state as j_make_state
from tpumd.io import read_data as j_rd
from tpumd.models import bonded as jb
from tpumd.script.parser import LammpsScript as JScript
from tpumd.utils.units import get_units as j_units
from tpumd_torch.bench_targets import IN_RHODO_CLASS
from tpumd_torch.core.state import Box
from tpumd_torch.io import read_data as t_rd
from tpumd_torch.interop import state_from_numpy
from tpumd_torch.md.fix_nh import FixNH, make_npt_z, make_nvt
from tpumd_torch.models import bonded as tb
from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist_plain
from tpumd_torch.script.parser import LammpsScript as TScript
from tpumd_torch.utils.units import get_units as t_units

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "peptide")
DATA = os.path.join(GOLDEN, "data.peptide")
KINDS = {"bond": ("bonds", jb.BondHarmonic, tb.BondHarmonic),
         "angle": ("angles", jb.AngleCharmm, tb.AngleCharmm),
         "dihedral": ("dihedrals", jb.DihedralCharmm, tb.DihedralCharmm),
         "improper": ("impropers", jb.ImproperHarmonic,
                      tb.ImproperHarmonic)}


def _deck(replicate="1 1 1"):
    return IN_RHODO_CLASS.format(golden=GOLDEN).replace(
        "replicate       2 2 4", f"replicate       {replicate}")


def _parsed(replicate="1 1 1"):
    """(tpumd sim, port sim) with the deck parsed, before any run."""
    js = JScript(data_dir=GOLDEN)
    js.run_string(_deck(replicate))
    js._finalize_atoms()
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(_deck(replicate))
    return js.sim, ts.sim


def test_read_data_full(tmp_path):
    jd, td = j_rd.read_data(DATA, "full"), t_rd.read_data(DATA, "full")
    for name in ("natoms", "nbonds", "nangles", "ndihedrals", "nimpropers",
                 "natomtypes", "nbondtypes", "nangletypes", "ndihedraltypes",
                 "nimpropertypes", "box_lo", "box_hi", "masses", "x", "v",
                 "types", "q", "molecule", "image", "bonds", "angles",
                 "dihedrals", "impropers"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name),
                                      err_msg=name)
    assert td.coeffs == {k: v for k, v in jd.coeffs.items()}
    assert (td.natoms, td.nangles, td.ndihedrals) == (2004, 786, 207)
    assert abs(td.q.sum()) < 1e-9 and td.q.max() > 0.5
    # the class2 cross-term sections keep raising
    path = tmp_path / "data.class2"
    path.write_text(open(DATA).read()
                    + "\nBondBond Coeffs\n\n1 0.0 1.0 1.0\n")
    with pytest.raises(NotImplementedError, match="BondBond"):
        t_rd.read_data(str(path), "full")


@pytest.mark.parametrize("replicate", ["1 1 2", "2 1 1"])
def test_replicate(replicate):
    jsim, tsim = _parsed(replicate)
    js, ts = jsim.state, tsim.state
    n = 2004 * 2
    assert tsim.natoms == jsim.natoms == n
    for name in ("tag", "molecule", "type", "q", "x", "v"):
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        assert a.shape[0] == n
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(ts.box.hi.numpy(), np.asarray(js.box.hi))
    # the same state carried over from tpumd's arrays
    carried = state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in ("x", "v", "f", "type",
                                                 "tag", "image", "q",
                                                 "molecule")},
        {"lo": np.asarray(js.box.lo), "hi": np.asarray(js.box.hi)},
        device="cpu", dtype=torch.float64)
    for name in ("tag", "molecule", "type", "q", "x"):
        assert torch.equal(getattr(carried, name), getattr(ts, name)), name
    assert sorted(tsim.topology) == sorted(jsim.topology)
    for kind, arr in jsim.topology.items():
        np.testing.assert_array_equal(tsim.topology[kind], arr, err_msg=kind)
    np.testing.assert_array_equal(tsim.special_tags, jsim.special_tags)
    np.testing.assert_array_equal(tsim.special_codes, jsim.special_codes)
    # replica 2's tuples name replica 2's atoms
    b = tsim.topology["bond"]
    assert (b[len(b) // 2:, 1:] > 2004).all()


def test_special_bonds():
    d = t_rd.read_data(DATA, "full")
    for a, b in zip(j_rd.build_special(d.natoms, d.bonds),
                    t_rd.build_special(d.natoms, d.bonds)):
        np.testing.assert_array_equal(b, a)
    st, sc = t_rd.build_special(d.natoms, d.bonds)
    # 4 1-2, 7 1-3, 14 1-4 partners at most: 18 per atom (log.ref)
    assert st.shape == (2004, 18) and set(np.unique(sc)) == {0, 1, 2, 3}
    for preset in ("charmm", "amber", "fene", "lj/coul 0.0 0.5 0.8"):
        j, t = JScript(), TScript(device="cpu", dtype=torch.float64)
        for script in (j, t):
            script.run_string(f"units real\nspecial_bonds {preset}\n")
        np.testing.assert_array_equal(t.sim.special_lj, j.sim.special_lj)
        np.testing.assert_array_equal(t.sim.special_coul,
                                      j.sim.special_coul)


def test_charmm_mixing_and_tables():
    jsim, tsim = _parsed()
    assert tsim.pair.mix == jsim.pair.mix == "arithmetic"
    jsim.pair.init()
    tsim.pair.init()
    for name in ("epsilon", "sigma", "eps14", "sigma14", "lj1", "lj2", "lj3",
                 "lj4", "lj14_1", "lj14_2", "lj14_3", "lj14_4"):
        np.testing.assert_array_equal(getattr(tsim.pair, name),
                                      getattr(jsim.pair, name), err_msg=name)
    for name in ("cut_ljsq", "cut_lj_innersq", "cut_coulsq", "denom_lj",
                 "max_cutoff"):
        assert getattr(tsim.pair, name) == getattr(jsim.pair, name), name
    assert tsim.pair.max_cutoff == 10.0
    # every pair is mixed from the diagonal: off-diagonal entries set
    assert (tsim.pair.epsilon[1:, 1:] > 0).all()


def _j_style(kind, d, jpair):
    cls = KINDS[kind][1]
    st = cls(getattr(d, f"n{kind}types"))
    for r in d.coeffs[kind.capitalize() + " Coeffs"]:
        st.coeff(int(r[0]), *[float(v) for v in r[1:]])
    st.set_topology(d.natoms, getattr(d, KINDS[kind][0]))
    st.units = j_units("real")
    st.init()
    return st


def _t_style(kind, d):
    st = KINDS[kind][2](getattr(d, f"n{kind}types"))
    for r in d.coeffs[kind.capitalize() + " Coeffs"]:
        st.coeff(int(r[0]), *[float(v) for v in r[1:]])
    st.init()
    return st


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bonded_style(kind):
    jsim, tsim = _parsed()
    jsim.pair.init()
    tsim.pair.init()
    d = t_rd.read_data(DATA, "full")
    # positions off equilibrium: every term is loaded
    x = d.x + np.random.default_rng(3).uniform(-0.1, 0.1, d.x.shape)
    jbox = JBox.orthogonal(d.box_lo, d.box_hi, dtype=jnp.float64)
    js = j_make_state(x, d.v, d.types, jbox, q=d.q, dtype=jnp.float64)
    jctx = SimpleNamespace(pair=jsim.pair, units=j_units("real"))
    jf, je, jv = _j_style(kind, d, jsim.pair).compute(js, jctx, True, True)
    jf, jv = np.asarray(jf), np.asarray(jv)

    box = Box.orthogonal(d.box_lo, d.box_hi, device="cpu",
                         dtype=torch.float64)
    tuples = np.array(getattr(d, KINDS[kind][0]), np.int64)
    tuples[:, 1:] -= 1
    view = (torch.as_tensor(x), torch.as_tensor(d.types),
            torch.as_tensor(d.q))
    tctx = SimpleNamespace(pair=tsim.pair, units=t_units("real"))
    tf, te, tv = tb.compute_tuples(_t_style(kind, d), view,
                                   torch.as_tensor(tuples), box, tctx, True,
                                   True)
    fmax = np.abs(jf).max()
    assert fmax > 1.0
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-12 * fmax)
    assert sorted(te) == sorted(je)
    for k in je:
        assert float(te[k]) == pytest.approx(float(je[k]), rel=1e-12,
                                             abs=1e-12), k
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0,
                               atol=1e-12 * np.abs(jv).max())
    if kind == "dihedral":
        # the 1-4 pairs tally as pair energies
        assert set(te) == {"edihed", "evdwl", "ecoul"}


def test_shake_clusters():
    jsim, tsim = _parsed()
    jfx = [fx for fx in jsim.fixes if fx.name == "shake"][0]
    jfx.build_clusters(jsim, None)
    excl = tsim.build_shake()
    tfx = tsim.shake_fixes()[0]
    for name in ("_c2", "_c3", "_c4", "_c3a"):
        np.testing.assert_array_equal(getattr(tfx, name),
                                      getattr(jfx, name), err_msg=name)
    np.testing.assert_array_equal(tfx._angle_dist, jfx._angle_dist)
    assert sorted(excl["bond"]) == sorted(jfx.excl_bond_rows)
    assert sorted(excl["angle"]) == sorted(jfx.excl_angle_rows)
    assert tfx.dof_removed == jfx.dof_removed > 0
    # mass 1.0 selects every bond to a hydrogen; angle type 31 is water's
    assert tfx.counts()[2] > 600
    assert tsim.dof() == 3 * 2004 - 3 - tfx.dof_removed


def test_nh_parse_and_real_units():
    fx = FixNH.parse("npt", "temp 300.0 300.0 100.0 z 0.0 0.0 1000.0 mtk "
                            "no pchain 0 tchain 1".split())
    assert fx.p_flags == (False, False, True) + (False,) * 3
    assert fx.mtchain == 1
    assert vars(fx) == vars(make_npt_z(300.0, 300.0, 100.0, 0.0, 0.0, 1000.0,
                                       tchain=1))
    nvt = FixNH.parse("nvt", "temp 275 275 100 tchain 1".split())
    assert vars(nvt) == vars(make_nvt(275.0, 275.0, 100.0, tchain=1))
    assert nvt.pdim == 0
    # LAMMPS's defaults (pchain 3, mtk yes) and iso parse; keywords neither
    # package takes, and tpumd's silent ones off their defaults, raise
    z = FixNH.parse("npt", "temp 300 300 100 z 0 0 1000".split())
    assert (z.mpchain, z.mtk, z.iso) == (3, True, False)
    assert FixNH.parse("npt", "temp 300 300 100 iso 0 0 1000 mtk no "
                              "pchain 0".split()).iso
    for args, match in (("temp 300 300 100 z 0 0 1000 couple xy".split(),
                         "couple"),
                        ("temp 300 300 100 iso 0 0 1000 tloop 2".split(),
                         "tloop")):
        with pytest.raises(NotImplementedError, match=match):
            FixNH.parse("npt", args)
    ju, tu = j_units("real"), t_units("real")
    for name in ("boltz", "mvv2e", "ftm2v", "mv2d", "nktv2p", "qqr2e",
                 "qe2f", "dt", "skin", "femtosecond"):
        assert getattr(tu, name) == getattr(ju, name), name
    assert tu.qqr2e == 332.06371


def test_barostat_rebins_a_shrunken_box():
    """Under a barostat the grid is re-validated after each segment: a box
    whose cells got shorter than cutneigh is re-binned with a 10 % wider
    margin (tpumd/md/simulation.py:1412-1430), one shorter than
    2 cutneigh raises."""
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(_deck("1 1 2"))
    ts.sim.verbose = False
    ts.run_string("run 0")
    sim = ts.sim
    assert (sim._neigh_cfg.nz, sim._baro_margin) == (4, 1.12)
    s, neigh, fstates = sim._carry

    def squeezed(f):
        lo, hi = s.box.lo.clone(), s.box.hi.clone()
        hi[2] = lo[2] + f * (hi[2] - lo[2])
        x = s.x.clone()
        x[:, 2] = lo[2] + (s.x[:, 2] - lo[2]) * f
        return s.replace(x=torch.where(neigh.valid[:, None], x, s.x),
                         box=Box(lo=lo, hi=hi))
    # 4 cells of 54.74 A * 0.87 / 4 = 11.9 A < cutneigh 12 A
    sim._carry = (squeezed(0.87), neigh, fstates)
    setups = sim.grid_setups
    sim._revalidate_geometry()
    s2, n2, _ = sim._carry
    assert sim._neigh_cfg.nz == 3
    # the re-bin built the new grid's pair list
    assert sim.grid_setups == setups + 1
    cfg2, k2 = sim._neigh_cfg, sim._ctx.pairlist_k
    assert tuple(n2.pairs.shape) == (cfg2.capacity, k2)
    fresh = cellgrid_pairlist_plain(s2.x, n2.valid, s2.tag, s2.special_tags,
                                    s2.special_codes, s2.box, cfg2, k2)
    assert torch.equal(n2.pairs, fresh[0]) and torch.equal(n2.npairs,
                                                            fresh[1])
    assert int(n2.npairs.sum()) > 0 and not bool(n2.overflow)
    assert sim._baro_margin == pytest.approx(1.12 * 1.10)
    assert n2.nbuilds == neigh.nbuilds
    tags = s2.tag[s2.tag > 0]
    assert sorted(tags.tolist()) == list(range(1, sim.natoms + 1))
    # every per-atom field followed its atom into the new slots
    k1, k2 = s.tag > 0, s2.tag > 0
    o1, o2 = torch.argsort(s.tag[k1]), torch.argsort(s2.tag[k2])
    for name in ("q", "type", "special_tags", "special_codes"):
        assert torch.equal(getattr(s, name)[k1][o1],
                           getattr(s2, name)[k2][o2]), name
    # below 2 cutneigh the cell grid cannot hold the box
    sim._carry = (squeezed(0.43), n2, fstates)
    with pytest.raises(RuntimeError, match="2\\*cutneigh"):
        sim._revalidate_geometry()
