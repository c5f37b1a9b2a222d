"""DPD in the port (tpumd_torch/models/pair_dpd.py) against tpumd on the CPU
in float64, on the matrix engine, and against the reference binary.

* The counter hash: on a (64, 32) grid of tag pairs at three steps the
  port's two 32-bit words equal tpumd's uint32 words bit for bit, and its
  uniforms too.  tpumd's float32 log and cos (XLA's CPU approximations)
  are not correctly rounded; the port takes them in float64 and rounds, so
  its normals equal the correctly rounded values of tpumd's recipe bit for
  bit and tpumd's own normals to 4 float32 ulps (ROADMAP C29).
* tests/golden/dpd (gamma = 0): the port's run meets log.dpd_cons at
  tpumd's tolerances (tests/test_dpd.py), and equals tpumd's run: every
  printed row to 1e-10 relative and the step-0 forces (a perfect lattice's,
  zero to 1e-15) to 1e-12.
* dpd with gamma > 0 and dpd/tstat on a 5^3 deck, 40 steps: every row
  equal to tpumd's to 1e-10, with tpumd's normals taken correctly rounded
  as the port's are (its pair_gaussian replaced in the test by the same
  words through float64 log, sqrt and cos).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.models import pair_dpd as jdpd
from tpumd_torch import kspace_goldens as kg
from tpumd_torch.models import pair_dpd as tdpd
from tpumd_torch.script.parser import LammpsScript as TScript
from torch_kspace_parity import assert_rows_equal, both

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def tpumd_words(tagi, tagj, step, seed):
    """tpumd's two uint32 words (tpumd/models/pair_dpd.py:42-51)."""
    lo = jnp.minimum(tagi, tagj).astype(jnp.uint32)
    hi = jnp.maximum(tagi, tagj).astype(jnp.uint32)
    stepu = jnp.asarray(step).astype(jnp.uint32)
    base = (lo * jnp.uint32(0x9E3779B1) ^ hi * jnp.uint32(0x85EBCA77)
            ^ (stepu * jnp.uint32(0xC2B2AE3D)) ^ jnp.uint32(seed))
    return (jdpd._murmur_fmix(base),
            jdpd._murmur_fmix(base ^ jnp.uint32(0x5BD1E995)))


def rounded_gaussian(tagi, tagj, step, seed):
    """tpumd's pair_gaussian with its log, sqrt and cos taken in float64
    and rounded to float32: the port's normals."""
    u1, u2 = tpumd_words(tagi, tagj, step, seed)
    f1 = (u1.astype(jnp.float32) + 1.0) * jnp.float32(2.3283064e-10)
    f2 = u2.astype(jnp.float32) * jnp.float32(2.3283064e-10)
    log = jnp.log(f1.astype(jnp.float64)).astype(jnp.float32)
    r = jnp.sqrt((-2.0 * log).astype(jnp.float64)).astype(jnp.float32)
    arg = jnp.float32(2.0 * np.pi) * f2
    return r * jnp.cos(arg.astype(jnp.float64)).astype(jnp.float32)


def tag_grid():
    rng = np.random.default_rng(2026)
    tagi = rng.integers(1, 2**31 - 1, (64, 1))
    tagi[:8, 0] = np.arange(1, 9)
    tagj = rng.integers(1, 2**31 - 1, (64, 32))
    tagj[:, 0] = tagi[:, 0]
    return tagi.astype(np.int32), tagj.astype(np.int32)


@pytest.mark.parametrize("step", [0, 7, 123456789])
def test_words_and_normals(step):
    tagi, tagj = tag_grid()
    seed = 928459
    ju1, ju2 = tpumd_words(jnp.asarray(tagi), jnp.asarray(tagj), step, seed)
    ti, tj = torch.as_tensor(tagi), torch.as_tensor(tagj)
    u1, u2 = tdpd.pair_words(ti, tj, step, seed)
    assert np.array_equal(u1.numpy(), np.asarray(ju1).astype(np.int64))
    assert np.array_equal(u2.numpy(), np.asarray(ju2).astype(np.int64))
    # symmetric under i <-> j
    v1, _ = tdpd.pair_words(tj, ti, step, seed)
    assert torch.equal(u1, v1)
    got = tdpd.pair_gaussian(ti, tj, step, seed).numpy()
    want = np.asarray(rounded_gaussian(jnp.asarray(tagi), jnp.asarray(tagj),
                                       step, seed))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # tpumd's own float32 normals: a few ulps (its log and cos are each
    # within about an ulp, and the product rounds once more)
    theirs = np.asarray(jdpd.pair_gaussian(jnp.asarray(tagi),
                                           jnp.asarray(tagj), step, seed))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - theirs.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(GOLD, "dpd", "in.dpd_cons")) as fh:
        text = fh.read()
    return both(text)


def test_dpd_golden_port_equals_tpumd(golden):
    js, ts, jrows, trows, jf0, tf0 = golden
    assert not ts.sim._ctx.is_cellgrid
    assert_rows_equal(trows, jrows)
    # the lattice's step-0 forces vanish (to 1e-15): held absolutely
    assert np.abs(tf0 - jf0).max() <= 1e-12 * max(np.abs(jf0).max(), 1.0)


def test_dpd_golden_against_reference(tmp_path):
    script = kg.run(GOLD, "dpd", str(tmp_path), "cpu", torch.float64)
    assert kg.failures(GOLD, "dpd", script, str(tmp_path)) == []


DECK_5 = """
units           lj
atom_style      atomic
comm_modify     vel yes
lattice         fcc 3.0
region          box block 0 5 0 5 0 5
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create {t0} 87287 loop geom
{pair}
neighbor        0.3 bin
neigh_modify    delay 0 every 1
fix             1 all nve
timestep        0.04
thermo          10
thermo_style    custom step temp epair etotal press
run             40
"""


@pytest.mark.parametrize("pair,t0", [
    ("pair_style dpd 1.0 1.0 34387\npair_coeff 1 1 25.0 4.5", 0.2),
    ("pair_style dpd/tstat 1.0 1.0 1.0 928459\npair_coeff 1 1 4.5", 3.0)],
    ids=["dpd", "dpd/tstat"])
def test_dpd_thermostat_port_equals_tpumd(pair, t0, monkeypatch):
    monkeypatch.setattr(jdpd, "pair_gaussian", rounded_gaussian)
    js, ts, jrows, trows, jf0, tf0 = both(DECK_5.format(pair=pair, t0=t0))
    assert_rows_equal(trows, jrows)
    # the random kick is on: the temperature moves toward kT = 1
    assert abs(trows[40]["temp"] - 1.0) < abs(t0 - 1.0)
    assert np.abs(tf0 - jf0).max() <= 1e-12 * np.abs(jf0).max()


def test_dpd_refusals():
    """The matrix engine only; a box narrower than 2 cutneigh and per-atom
    tallies raise, naming the style."""
    deck = DECK_5.format(pair="pair_style dpd 1.0 1.0 34387\n"
                              "pair_coeff 1 1 25.0 4.5", t0=1.0)
    pre = deck.rsplit("\nrun", 1)[0]
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(pre)
    script.sim.neighbor_mode = "cellgrid"
    with pytest.raises(NotImplementedError, match="dpd"):
        script.run_string("run 0")
    small = pre.replace("0 5 0 5 0 5", "0 1 0 1 0 1")
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(small)
    with pytest.raises(NotImplementedError, match="dpd"):
        script.run_string("run 0")


@pytest.mark.slow
def test_dpd32k_step0_targets(golden):
    """IN_DPD32K's step-0 row through the port on the CPU in f64 (~5 s):
    the card's targets (bench_targets.DPD32K_STEP0_F64) to 1e-12, its
    conservative part (epair, per particle) tpumd's 4^3 golden cell's
    (gamma = 0, the same lattice) to 1e-12, the temperature 1."""
    from tpumd_torch import bench_targets as bt
    jrows = golden[2]
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(bt.IN_DPD32K.format(n=bt.DPD32K_CELLS, thermo=100))
    script.sim.verbose = False
    script.run_string("run 0")
    row = script.sim.last_thermo
    assert script.sim.natoms == 4 * bt.DPD32K_CELLS ** 3
    for k, want in bt.DPD32K_STEP0_F64.items():
        assert row[k] == pytest.approx(want, rel=1e-12), k
    assert row["epair"] == pytest.approx(float(jrows[0]["epair"]),
                                         rel=1e-12)
    assert row["temp"] == pytest.approx(1.0, rel=1e-14)


def test_dpd_tstat_keeps_t_start():
    """dpd/tstat's temperature stays t_start over a run, as tpumd keeps it
    (ROADMAP C30: LAMMPS ramps it to t_stop)."""
    deck = DECK_5.format(pair="pair_style dpd/tstat 2.0 1.0 1.0 928459\n"
                              "pair_coeff 1 1 4.5", t0=2.0)
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(deck.replace("run             40", "run 4"))
    pair = script.sim.pair
    assert (pair.t_start, pair.t_stop, pair.temperature) == (2.0, 1.0, 2.0)


def test_dpd_tables_carried_from_tpumd(golden):
    """tpumd's coefficient tables and seed carried into the port's style
    (interop.with_pair_tables) equal the port's own and leave its forces
    unchanged."""
    from tpumd_torch.interop import with_pair_tables
    from tpumd_torch.md.verlet import compute_forces
    js, ts = golden[:2]
    jp, tp = js.sim.pair, ts.sim.pair
    for name in ("a0", "gamma", "cut", "cutsq"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
    assert (tp.seed, tp.temperature) == (jp.seed, jp.temperature)
    s, neigh, _ = ts.sim._carry
    ctx = ts.sim._ctx
    f = compute_forces(s, neigh, ctx, False, False, istep=3)[0]
    with_pair_tables(tp, {name: np.asarray(getattr(jp, name))
                          for name in ("a0", "gamma", "cut", "cutsq")}
                     | {"seed": jp.seed, "temperature": jp.temperature})
    assert torch.equal(compute_forces(s, neigh, ctx, False, False,
                                      istep=3)[0], f)
