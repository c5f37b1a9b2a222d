"""The barostat and fix shake's clusters of several sizes decomposed over
gloo ranks on the CPU in f64 (ROADMAP item 14d, C43), against the port's
one-rank run and tpumd's:

* water_npt (fix npt iso, SHAKE ``b 1 a 1``, pppm) replicated 2x2x2,
  re-binned every 5 steps, 10 steps: its grid has 3 z planes under the
  barostat's cell margin, so 4 ranks lay it out as 2 x 2 pencils and 2
  ranks as z-slabs.  x and v by tag, the box and the thermo rows equal the
  one-rank run's to 1e-10, and x, v and the box equal tpumd's run of the
  deck with ``bonded_grid`` sharded over the 8 virtual devices
  (``shard_carry``) to 1e-10.  Between output steps a pencil step makes
  five all-reduces (fix npt's three in its first half and one in its
  second, pppm's mesh) and no all-gather.
* ``bench_targets.IN_SHAKE_MIXTURE`` (water, methanol and formaldehyde:
  SHAKE clusters of 2, 3 and 4 atoms and angle clusters, ROADMAP C43) on
  one rank with ``bonded_grid`` on equals it off to 1e-12; over 2
  z-slabs it equals the one-rank run to 1e-10; and both equal the rows of
  tpumd's ``bonded_grid`` run to 1e-10 (``MIXTURE_TPUMD``; ``-m slow``
  runs tpumd again for them and for the peptide's rows of
  ``tests/test_torch_decomp_thermostats.py``, ~2 min).

The workers are spawned once for the module (``parallel/launch.py``).
"""

import os

import numpy as np
import pytest

from test_torch_decomp_thermostats import GOLDEN, PEPTIDE_NVE, \
    PEPTIDE_NVE_TPUMD, assert_same_run, golden, one_rank, spawn_worlds, spec
from tpumd_torch import bench_targets as bt

STEPS = 10
WATER = spec(golden("water_npt", "2 2 2"), steps=STEPS,
             data_dir=os.path.join(GOLDEN, "water_npt"))
STEADY = 2
# name: (ranks, processor grid)
RUNS = {"water_npt_pencils": (4, (2, 2)), "water_npt_slabs": (2, (2, 1)),
        "mixture_slabs": (2, (2, 1))}
# tpumd's rows of the mixture with bonded_grid on the cell grid (f64,
# CPU): (step, etotal, temp, press)
MIXTURE_TPUMD = (
    (0, 601.7502788235867, 300.0000000000001, 1645.804208405043),
    (5, 454.54678481731423, 189.80331939192536, -122.1055430405353),
    (10, 453.66619437804746, 236.623789918182, 208.82271799153366))


@pytest.fixture(scope="module")
def mixture(tmp_path_factory):
    path = tmp_path_factory.mktemp("mixture") / "data.mixture"
    assert bt.shake_mixture_data(str(path)) == 936
    return spec(bt.IN_SHAKE_MIXTURE.format(data=path), steps=STEPS)


@pytest.fixture(scope="module")
def specs(mixture):
    return {"water_npt_pencils": {**WATER, "steady": STEADY},
            "water_npt_slabs": WATER, "mixture_slabs": mixture}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, specs):
    return spawn_worlds(tmp_path_factory.mktemp("npt"), {
        k: (RUNS[k][0], specs[k]) for k in RUNS})


@pytest.fixture(scope="module")
def refs(mixture):
    return {"water": one_rank(WATER), "mixture": one_rank(mixture),
            "mixture_grid": one_rank(mixture, bonded_grid=True)}


def _by_tag(s):
    tag = np.asarray(s.tag)
    keep = np.nonzero(tag > 0)[0]
    order = keep[np.argsort(tag[keep])]
    return np.asarray(s.x)[order], np.asarray(s.v)[order]


def tpumd_rows(setup):
    """(step, etotal, temp, press) of tpumd's run of a deck, bonded_grid
    on the cell grid, STEPS steps."""
    from tpumd.script.parser import LammpsScript as JScript
    script = JScript()
    script.run_string(setup)
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    sim.bonded_grid = True
    script.run_string(f"run {STEPS}")
    return [(r["step"], r["etotal"], r["temp"], r["press"])
            for r in sim.thermo_rows]


@pytest.fixture(scope="module")
def tpumd_sharded():
    """(x, v, box lengths) of tpumd's water_npt 2x2x2 with bonded_grid, 10
    steps sharded over the 8 virtual devices."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from tpumd.md.verlet import run_segment
    from tpumd.parallel.mesh import make_mesh, shard_carry
    from tpumd.script.parser import LammpsScript as JScript
    script = JScript(data_dir=WATER["data_dir"])
    script.run_string(WATER["setup"])
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    sim.bonded_grid = True
    sim._ctx = None
    sim.setup()
    assert sim._ctx.bonded_grid
    s = run_segment(shard_carry(sim._carry, make_mesh(8)), sim._ctx,
                    STEPS, consts=sim._consts)[0]
    assert len(s.x.sharding.device_set) == 8
    x, v = _by_tag(s)
    return x, v, np.asarray(s.box.hi) - np.asarray(s.box.lo)


@pytest.mark.parametrize("name", RUNS)
def test_decomposed_run_equals_the_one_rank_run(name, worlds, refs):
    nprocs, grid = RUNS[name]
    ranks = worlds[name]
    assert len(ranks) == nprocs
    ref = refs[name.split("_")[0]]
    for r in ranks:
        assert (r["layout"]["pz"], r["layout"]["py"]) == grid
        assert_same_run(r, ref)
        assert r["nbuilds"] >= 3
    if name.startswith("water"):
        assert ref["rows"][-1]["vol"] != ref["rows"][0]["vol"]


@pytest.mark.parametrize("name", ["water_npt_pencils", "water_npt_slabs"])
def test_decomposed_water_npt_equals_tpumd_sharded(name, worlds,
                                                   tpumd_sharded):
    x, v, box = tpumd_sharded
    for r in worlds[name]:
        np.testing.assert_allclose(r["x"], x, rtol=0, atol=1e-10)
        np.testing.assert_allclose(r["v"], v, rtol=0, atol=1e-10)
        np.testing.assert_allclose(r["box"], box, rtol=1e-10, atol=0)


def test_mixture_shake_on_the_tag_matched_path(refs):
    """C43: every cluster kind on the tag-matched path, on one rank,
    equals the tag-order view's solve to 1e-12."""
    on, off = refs["mixture_grid"], refs["mixture"]
    assert on["sim"]._ctx.bonded_grid and not off["sim"]._ctx.bonded_grid
    assert on["sim"].shake_fixes()[0].counts() == (72, 72, 72, 72)
    assert_same_run(on, off, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("which", ["mixture_grid", "mixture_slabs"])
def test_mixture_rows_equal_tpumds(which, refs, worlds):
    runs = worlds[which] if which in worlds else [refs[which]]
    for r in runs:
        assert len(r["rows"]) == len(MIXTURE_TPUMD)
        for row, (step, etotal, temp, press) in zip(r["rows"],
                                                     MIXTURE_TPUMD):
            assert row["step"] == step
            assert row["etotal"] == pytest.approx(etotal, rel=1e-10)
            assert row["temp"] == pytest.approx(temp, rel=1e-10)
            assert row["press"] == pytest.approx(press, rel=1e-10)


@pytest.mark.slow
@pytest.mark.parametrize("deck", ["peptide", "mixture"])
def test_pinned_rows_are_tpumds(deck, mixture):
    """The pinned rows come from tpumd's bonded_grid runs (f64, CPU)."""
    setup, want = {"peptide": (PEPTIDE_NVE, PEPTIDE_NVE_TPUMD),
                   "mixture": (mixture["setup"], MIXTURE_TPUMD)}[deck]
    got = tpumd_rows(setup)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array(got)[:, 1:], np.array(want)[:, 1:],
                               rtol=1e-13, atol=0)


def test_npt_steps_between_outputs(worlds):
    """Fix npt's three all-reduces in the first half of a step (the
    temperature, the kinetic tensor, the step's virial) and one in the
    second, pppm's mesh once a force evaluation; no all-gather on the
    grid."""
    for r in worlds["water_npt_pencils"]:
        st = r["steady"]
        assert st["calls"]["all_reduce"] == STEADY * 5
        assert st["calls"]["all_gather"] == 0
        assert st["calls"]["exchange"] > 0
