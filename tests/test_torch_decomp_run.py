"""Decks run decomposed over gloo ranks on the CPU, in f64, against the
port's own one-rank run (``tpumd_torch/parallel/``; the workers spawned
through ``parallel/launch.py``, three worlds in all):

* in.lj on 8^3 fcc cells (2,048 atoms, 4^3 cell grid), 20 steps over four
  re-bins (``neigh_modify every 5 check no``): as 4 z-slabs and on 2
  ranks; on 6^3 cells (3^3 grid) on 4 ranks as 2 x 2 pencils; on 4^3
  cells (a 2^3 grid, nz = 2) on 2 ranks, where both halos of a rank come
  from the other rank, one shifted by the box length; and 4^3 on the
  matrix engine on 4 ranks (tpumd's tests/test_sharding.py deck);
* eam (``bench_targets.eam_funcfl``, 5^3 cells, a 3^3 grid split 1 + 2)
  with ``check yes`` on 2 ranks, the re-bin decisions agreed;
* a world of one: the one-card rows and no exchange.

Each run's x and v in tag order equal the one-rank run's to 1e-12 (they
come out bit-equal: every owned row sums the one-card list's entries in
their order) and its log's rows equal it at the printed digits (the
Loop time and Performance lines excepted).  B1 (or B3 and B4) runs once a
force evaluation on every rank, as on one card.  Between output steps a
grid step makes no all-gather and no all-reduce under ``check no``: one
exchange round a split axis, whose bytes are the rank's halo planes'
positions.  Under a world size above 1 fix rigid, fix rattle,
``kspace_style ewald`` and ``boundary p p s`` raise, naming the command
and ROADMAP item 14e (what runs across ranks is not ported yet); bond
styles and pppm run across ranks since item 14b
(tests/test_torch_decomp_molecular.py), the thermostats and barostats
since item 14d (tests/test_torch_decomp_thermostats.py).
"""

import numpy as np
import pytest
import torch

from tpumd_torch.bench_targets import IN_EAM, IN_LJ, eam_funcfl
from tpumd_torch.parallel.launch import run_decks, spawn_world, tag_order
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

STEPS = 20


def _lj(n, every=5):
    deck = IN_LJ.format(n=n).replace("every 20 check no",
                                     f"every {every} check no")
    return deck + "thermo 5\n"


def _spec(setup, mode="cellgrid", steady=0):
    return {"setup": setup, "mode": mode, "runs": [f"run {STEPS}"],
            "steady": steady}


BASE = IN_LJ.format(n=6)
REFUSALS = {
    "fix 2 rigid": BASE + "fix 2 all rigid single\n",
    "kspace_style ewald": BASE + "kspace_style ewald 1e-4\n",
    "fix 2 rattle": BASE + "fix 2 all rattle 0.0001 10 0 b 1\n",
    "boundary p p s": "boundary p p s\n" + BASE,
}
# the ROADMAP item each refusal names
REFUSAL_ITEMS = {"fix 2 rigid": "14e", "kspace_style ewald": "14e",
                 "fix 2 rattle": "14e", "boundary p p s": "14e"}


@pytest.fixture(scope="module")
def eam_setup(tmp_path_factory):
    pot = tmp_path_factory.mktemp("eam") / "Cu.eam"
    eam_funcfl(str(pot))
    return IN_EAM.format(n=5, potential=pot).replace("thermo          50",
                                                     "thermo 5")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, eam_setup):
    """{name: [each rank's run_deck result]} of every decomposed run."""
    d = tmp_path_factory.mktemp("worlds")
    four = {"lj8_slabs": _spec(_lj(8), steady=4),
            "lj6_pencils": _spec(_lj(6), steady=4),
            "lj4_matrix": _spec(_lj(4), mode="matrix", steady=4)}
    four.update({name: {"setup": deck, "runs": ["run 5"], "refusal": name}
                 for name, deck in REFUSALS.items()})
    two = {"lj8_two": _spec(_lj(8)),
           "eam_check_yes": _spec(eam_setup),
           "lj4_nz2": _spec(_lj(4), steady=4)}
    one = {"lj8_one": _spec(_lj(8), steady=4)}
    out = {}
    for nprocs, specs in ((4, four), (2, two), (1, one)):
        ranks = spawn_world(run_decks, nprocs, "gloo", d / f"pg{nprocs}",
                            (list(specs.values()),), timeout=240)
        for k, name in enumerate(specs):
            out[name] = [r[k] for r in ranks]
    return out


def _one_rank(spec):
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(spec["setup"])
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = spec["mode"]
    for piece in spec["runs"]:
        script.run_string(piece)
    x, v = tag_order(sim.state, "x", "v")
    return {"log": list(sim.log_lines), "x": x, "v": v}


def _rows(log):
    return [line for line in log
            if not line.startswith(("Loop time", "Performance"))]


RUNS = {"lj8_slabs": (4, 1), "lj6_pencils": (2, 2), "lj4_matrix": None,
        "lj8_two": (2, 1), "eam_check_yes": (2, 1), "lj4_nz2": (2, 1),
        "lj8_one": (1, 1)}


@pytest.mark.parametrize("name", RUNS)
def test_decomposed_run_equals_the_one_rank_run(name, worlds, eam_setup):
    setup = {"lj8": _lj(8), "lj6": _lj(6), "lj4": _lj(4),
             "eam": eam_setup}[name.split("_")[0]]
    ref = _one_rank(_spec(setup, "matrix" if "matrix" in name
                          else "cellgrid"))
    ranks = worlds[name]
    want = RUNS[name]
    for r in ranks:
        if want is not None:
            assert (r["layout"]["pz"], r["layout"]["py"]) == want
        np.testing.assert_allclose(r["x"], ref["x"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["v"], ref["v"], rtol=0, atol=1e-12)
        assert _rows(r["log"]) == _rows(ref["log"])
        assert r["natoms"] == len(ref["x"])
    assert f"on {len(ranks)} devices" in [
        line for line in ranks[0]["log"] if line.startswith("Loop")][0]
    if name == "lj4_nz2":
        assert ranks[0]["layout"]["local"][0] == 3


@pytest.mark.parametrize("name", ["lj8_slabs", "lj6_pencils", "lj4_nz2",
                                  "eam_check_yes", "lj8_one"])
def test_force_kernels_run_once_a_force_evaluation(name, worlds):
    # a set-up, the steps, and the thermo rows' evaluations at 5-20
    evals = 1 + STEPS + STEPS // 5
    for r in worlds[name]:
        c = r["counts"]
        if name.startswith("eam"):
            assert c["rho"] == (0, evals) and c["force"] == (0, evals)
        else:
            assert c["b1"] == (0, evals)
        # the set-up's build and one a re-bin
        assert c["build"] == (0, r["nbuilds"])


@pytest.mark.parametrize("name", ["lj8_slabs", "lj6_pencils", "lj4_nz2",
                                  "lj8_one", "lj4_matrix"])
def test_steps_between_outputs_move_the_halos_only(name, worlds):
    for r in worlds[name]:
        steady = r["steady"]
        nsteps = 4
        assert steady["calls"]["all_reduce"] == 0
        if name == "lj4_matrix":
            # the matrix engine's rows read every position: an all-gather
            # a step, padded to the largest block of rows
            width = int(np.ceil(r["natoms"] / 4))
            assert steady["calls"] == {"exchange": 0, "all_reduce": 0,
                                       "all_gather": nsteps}
            assert steady["bytes"]["all_gather"] == \
                nsteps * 4 * width * 3 * r["itemsize"]
            continue
        assert steady["calls"]["all_gather"] == 0
        nz, ny, nx, cap = r["layout"]["local"]
        pz, py = r["layout"]["pz"], r["layout"]["py"]
        plane = 3 * r["itemsize"] * nx * cap
        per_step = (2 * ny * plane if pz > 1 else 0) + \
            (2 * nz * plane if py > 1 else 0)
        assert steady["calls"]["exchange"] == nsteps * ((pz > 1) + (py > 1))
        assert steady["bytes"]["exchange"] == nsteps * per_step
        # the whole run: all-gathers only at its end (the gathered state)
        assert r["collectives"]["calls"]["all_gather"] == 2
    if name == "lj8_one":
        assert worlds[name][0]["collectives"]["calls"]["exchange"] == 0


@pytest.mark.parametrize("what", REFUSALS)
def test_refusals_across_ranks_name_the_command(what, worlds):
    for r in worlds[what]:
        assert what in r["refused"]
        assert f"item {REFUSAL_ITEMS[what]}" in r["refused"]
