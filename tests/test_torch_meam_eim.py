"""meam and eim in the port.

* The two MEAM goldens (tests/golden/meam: the SiC deck ``in.meam`` and
  the Ni deck ``in.ni``) through the port alone, against the reference
  binary's step-20 rows at tests/test_meam.py's tolerances.
* meam on the two-element SiC state moved off its sites, and eim on a
  seeded rock-salt crystal with the generated ``bench_targets.FFIELD_EIM``:
  the tables both packages build from the files (MEAM's phi table and
  reference densities, EIM's splines) equal, then carried from tpumd's
  style into the port's; forces, energy (and eim's virial) through both
  packages' ``compute`` on the port's neighbor rows, to 1e-10 relative;
  eim's 10-step NVE rows equal.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.models.registry import create_pair_style as j_create
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.interop import with_pair_tables
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "meam")

def meam_deck(name, tmp_path):
    for f in ("data.meam", "library.meam", "SiC.meam", "Ni.meam"):
        shutil.copy(os.path.join(GOLD, f), tmp_path)
    with open(os.path.join(GOLD, name)) as fh:
        return bt.meam_golden_deck(fh.read())


@pytest.mark.parametrize("name", sorted(bt.MEAM_GOLDEN_ROWS))
def test_meam_golden(name, tmp_path):
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.data_dir = str(tmp_path)
    ts.run_string(meam_deck(name, tmp_path))
    assert ts.sim._mode == "matrix" and ts.sim.step == 20
    v = ts.sim.last_thermo
    for k, want in bt.MEAM_GOLDEN_ROWS[name].items():
        assert v[k] == pytest.approx(want, rel=1e-5 if k == "press"
                                     else 1e-6), k



def jax_compute(jpair, x, type_, box, idx, sbits, vflag):
    """tpumd's style's compute (f, evdwl, ecoul, virial) under one jax.jit:
    one compile instead of a dispatch a primitive."""
    import jax
    return jax.jit(lambda x_, t_, b_, i_, s_: jpair.compute(
        x_, t_, b_, i_, s_, None, None, True, vflag))(x, type_, box, idx,
                                                       sbits)

def close(a, b, rel=1e-10):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    return a.shape == b.shape and float(np.abs(a - b).max()) <= rel * scale


def against_tpumd(ts, name, coeff_args, tables=()):
    """The port's and tpumd's (f, e, virial) of the port's state;
    the tables named are carried from tpumd's style into the port's
    (``interop.with_pair_tables``) after checking that both built them
    alike."""
    import jax.numpy as jnp
    sim = ts.sim
    jpair = j_create(name, sim.ntypes, [])
    jpair.coeff(1, sim.ntypes, 1, sim.ntypes, *coeff_args)
    jpair.init()
    for t in tables:
        np.testing.assert_array_equal(getattr(sim.pair, t),
                                      getattr(jpair, t), err_msg=t)
    with_pair_tables(sim.pair, {t: getattr(jpair, t) for t in tables})
    s, neigh = sim._carry[0], sim._carry[1]
    f, e, _, v = sim.pair.compute(s.x, s.type, s.box, neigh.idx,
                                  neigh.sbits, None, None, True, True)
    jf, je, _, jv = jax_compute(jpair, 
        jnp.asarray(s.x.numpy()), jnp.asarray(s.type.numpy()),
        JBox.orthogonal(s.box.lo.numpy(), s.box.hi.numpy()),
        jnp.asarray(neigh.idx.numpy()), jnp.asarray(neigh.sbits.numpy()),
        True)
    return (f.numpy(), float(e), v.numpy()), (np.asarray(jf), float(je),
                                               np.asarray(jv))


def test_meam_two_elements_against_tpumd(tmp_path):
    """The SiC golden's state (data.meam, 2 elements) moved off its sites:
    forces, energy and the virial's diagonal to 1e-10 (its off-diagonal
    terms: ROADMAP C26)."""
    deck = meam_deck("in.meam", tmp_path).split("velocity")[0]
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.data_dir = str(tmp_path)
    ts.run_string(deck + "displace_atoms all random 0.1 0.1 0.1 4711 "
                  "units box\nrun 0\n")
    args = [os.path.join(str(tmp_path), "library.meam"), "Si", "C",
            os.path.join(str(tmp_path), "SiC.meam"), "Si", "C"]
    (f, e, v), (jf, je, jv) = against_tpumd(
        ts, "meam", args,
        tables=("_phi_tab", "rho_ref", "eltind", "ebound", "Cmin", "Cmax"))
    assert set(np.unique(ts.sim.state.type.numpy())) == {1, 2}
    assert float(np.abs(f).max()) > 0.1
    assert close(f, jf)
    assert e == pytest.approx(je, rel=1e-10)
    assert close(v[:3], jv[:3])


EIM_HEAD = """units metal
atom_style atomic
read_data {data}
pair_style eim
pair_coeff * * Na Cl {ffield} Na Cl
neighbor 1.0 bin
"""


def eim_deck(tmp_path, displace):
    data = os.path.join(tmp_path, "data.nacl")
    bt.two_type_data(data, "rocksalt", 3, displace=displace)
    ffield = os.path.join(tmp_path, "ffield.eim")
    with open(ffield, "w") as fh:
        fh.write(bt.FFIELD_EIM)
    return EIM_HEAD.format(data=data, ffield=ffield), ffield


def test_eim_against_tpumd(tmp_path):
    deck, ffield = eim_deck(tmp_path, 0.15)
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(deck + "run 0\n")
    assert ts.sim._mode == "matrix"
    (f, e, v), (jf, je, jv) = against_tpumd(
        ts, "eim", ["Na", "Cl", ffield, "Na", "Cl"],
        tables=("Fij_spline", "Gij_spline", "phiij_spline", "type2Fij",
                "type2Gij", "q0"))
    assert float(np.abs(f).max()) > 0.1
    assert close(f, jf)
    assert e == pytest.approx(je, rel=1e-10)
    assert close(v, jv)


def test_eim_deck_rows_against_tpumd(tmp_path):
    deck, _ = eim_deck(tmp_path, 0.0)
    deck += ("velocity all create 1400.0 43454 loop geom\nfix 1 all nve\n"
             "timestep 0.001\nthermo 5\nrun 10\n")
    js = JScript()
    js.run_string(deck)
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(deck)
    rows = [[ln for ln in sim.log_lines if not ln.startswith(
        ("Loop time", "Performance", "Neighbor"))] for sim in (js.sim,
                                                             ts.sim)]
    assert len(rows[1]) == 4 and rows[1] == rows[0]
