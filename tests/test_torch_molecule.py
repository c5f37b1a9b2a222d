"""Molecule templates, create_atoms ... mol and create_box's keywords and
tilted prisms in the port, on the CPU in float64.

* tests/golden/create_mol verbatim (64 TIP3P-like waters on an sc lattice,
  10 NVE steps) against the reference binary's log at
  tests/test_create_mol.py's tolerance (rel 1e-7): the placement is bit for
  bit, which ``velocity ... loop geom`` sees.
* The same deck's atoms, charges, molecule ids, image flags, topology and
  special lists equal tpumd's exactly.
* create_box on a tilted prism: the triclinic box and its rows equal
  tpumd's; a create_box keyword the port lacks raises, naming itself.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from tpumd_torch import remainder_goldens as rg
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MOL = os.path.join(GOLD, "create_mol")

PRISM = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box prism 0 5 0 5 0 5 1.0 0.5 0.25
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    every 1 delay 0 check yes
fix             1 all nve
thermo          5
run             10
"""


def test_create_mol_golden_against_reference(tmp_path):
    script = rg.run(GOLD, "create_mol", str(tmp_path), "cpu", torch.float64)
    assert script.sim.step == 10
    assert rg.failures(GOLD, "create_mol", script, str(tmp_path)) == []


def test_template_placement_equals_tpumd():
    import jax
    from tpumd.script.parser import LammpsScript as JScript
    with open(os.path.join(MOL, "in.createmol")) as fh:
        deck = "\n".join(ln for ln in fh.read().splitlines()
                         if not ln.startswith(("run", "velocity")))
    j = JScript(data_dir=MOL)
    j.run_string(deck)
    j._finalize_atoms()
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = MOL
    t.run_string(deck)
    t._finalize_atoms()
    js, ts = j.sim.state, t.sim.state
    for name in ("x", "type", "q", "molecule", "image", "tag"):
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(),
            np.asarray(jax.device_get(getattr(js, name))), err_msg=name)
    assert t.sim.natoms == 192
    for kind in ("bond", "angle"):
        np.testing.assert_array_equal(t.sim.topology[kind],
                                      j.sim.topology[kind])
    np.testing.assert_array_equal(t.sim.special_tags, j.sim.special_tags)
    np.testing.assert_array_equal(t.sim.special_codes, j.sim.special_codes)
    assert t.sim.bonded_ntypes["bond"] == 1
    assert t.sim.extra_per_atom == {"bond": 2, "angle": 1, "special": 4}


def test_tilted_prism_box_equals_tpumd():
    from tpumd.script.parser import LammpsScript as JScript
    j = JScript()
    with contextlib.redirect_stdout(sys.stderr):
        j.run_string(PRISM)
    t = TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(PRISM)
    assert t.sim.state.box.istriclinic
    assert t.sim._mode == "matrix"
    np.testing.assert_allclose(t.sim.state.box.tilt.numpy(),
                               [1.0 * 1.6796, 0.5 * 1.6796, 0.25 * 1.6796],
                               rtol=1e-4)
    for k in ("temp", "epair", "etotal", "press"):
        assert t.sim.last_thermo[k] == pytest.approx(
            j.sim.last_thermo[k], rel=1e-10), k


@pytest.mark.parametrize("line,match", [
    ("create_box 1 box bond/types 1 foo 2", "foo"),
    ("create_box 1 box extra/bond/per/atom", "odd"),
])
def test_create_box_keyword_refusals(line, match):
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string("units lj\nlattice fcc 0.8442\nregion box block 0 2 0 2 "
                 "0 2\n")
    with pytest.raises(Exception, match=match):
        t.run_string(line)
