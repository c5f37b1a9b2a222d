"""The r/k-space split (tpumd_torch/parallel/rkspace.py) on the CPU in f64:
its plain version, the two parts one after the other.

* tests/test_rkspace_split.py's deck (the tip4p golden's water with
  lj/cut/coul/long and PPPM, on the matrix engine): the split equals the
  port's fused evaluation to 1e-11 and tpumd's dryrun_rk_split (two of its
  virtual CPU devices) to 1e-10, by tag.
* The peptide with the rhodo_class settings on the grid (B5's plain list
  sweep and PPPM): the split equals the fused evaluation to 1e-11.
* The tip4p golden: k-space on the charge sites, spread back onto the
  atoms, = the fused evaluation to 1e-11.
* Without a kspace solver the split is the r-space sum alone.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tpumd.parallel.rkspace import dryrun_rk_split as jsplit
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import IN_RHODO_CLASS
from tpumd_torch.parallel.rkspace import dryrun_rk_split, make_split_force_fn
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
GOLD = os.path.join(os.path.dirname(__file__), "golden")

DECK = """
units           real
atom_style      full
bond_style      harmonic
angle_style     harmonic
pair_style      lj/cut/coul/long 6.0 7.0
kspace_style    pppm 1e-4
special_bonds   lj/coul 0.0 0.0 0.5
read_data       data.water
bond_coeff      1 450.0 0.9572
angle_coeff     1 55.0 104.52
pair_coeff      1 1 0.1521 3.1507
pair_coeff      2 2 0.0 1.0
neighbor        2.0 bin
fix             1 all nve
run             0
"""


def by_tag(f, tag):
    f, tag = np.asarray(f), np.asarray(tag)
    live = tag > 0
    return f[live][np.argsort(tag[live])]


def port(deck, data_dir):
    script = TScript(device="cpu", dtype=torch.float64)
    script.data_dir = data_dir
    with contextlib.redirect_stdout(io.StringIO()):
        script.run_string(deck)
    return script.sim


def test_split_equals_fused_and_tpumd():
    golden = os.path.join(GOLD, "tip4p")
    sim = port(DECK, golden)
    assert not sim._ctx.is_cellgrid and sim._ctx.kspace is not None
    f_split, f_fused = dryrun_rk_split(sim)
    np.testing.assert_allclose(f_split.numpy(), f_fused.numpy(), rtol=0,
                               atol=1e-11)
    assert float(f_fused.abs().max()) > 0
    ref = JScript(data_dir=golden)
    with contextlib.redirect_stdout(io.StringIO()):
        ref.run_string(DECK)
    j_split, j_fused = jsplit(ref.sim, 2)
    tag = sim._carry[0].tag
    jtag = ref.sim._carry[0].tag
    np.testing.assert_allclose(by_tag(f_split, tag), by_tag(j_split, jtag),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(by_tag(f_fused, tag), by_tag(j_fused, jtag),
                               rtol=0, atol=1e-10)


def test_split_on_the_grid_peptide():
    deck = IN_RHODO_CLASS.format(golden=os.path.join(GOLD, "peptide")) \
        .replace("replicate       2 2 4\n", "") + "run 0\n"
    sim = port(deck, GOLD)
    assert sim._ctx.is_cellgrid and sim.pair.charged
    f_split, f_fused = dryrun_rk_split(sim)
    scale = float(f_fused.abs().max())
    assert float((f_split - f_fused).abs().max()) <= 1e-11 * scale


def test_split_on_tip4p_sites():
    """The tip4p golden (lj/cut/tip4p/long, pppm/tip4p): k-space on the
    charge sites, their forces spread back onto the atoms, = the fused
    evaluation to 1e-11 of max|f| (the spread is linear: the two sums
    round apart)."""
    from tpumd_torch import kspace_goldens as kg
    deck = kg.deck_text(GOLD, "tip4p").rsplit("\nrun", 1)[0] + "\nrun 0\n"
    sim = port(deck, os.path.join(GOLD, "tip4p"))
    assert sim.pair.is_tip4p and sim.kspace.style == "pppm/tip4p"
    f_split, f_fused = dryrun_rk_split(sim)
    scale = float(f_fused.abs().max())
    assert float((f_split - f_fused).abs().max()) <= 1e-11 * scale


def test_split_without_kspace_is_the_rspace_sum():
    deck = DECK.replace("kspace_style    pppm 1e-4\n", "").replace(
        "lj/cut/coul/long 6.0 7.0", "lj/cut/coul/cut 6.0 7.0")
    sim = port(deck, os.path.join(GOLD, "tip4p"))
    s, neigh, _ = sim._carry
    f = make_split_force_fn(sim._ctx)(s, neigh)
    assert torch.equal(f, dryrun_rk_split(sim)[1])
