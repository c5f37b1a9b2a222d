"""The molecular stack decomposed over gloo ranks on the CPU, in f64
(ROADMAP item 14b): the water_nve and water_shake goldens
(lj/charmm/coul/long, pppm 1e-4, special_bonds charmm, harmonic bonds,
charmm angles; fix shake's 125 angle clusters in water_shake), their
rebuild schedule set to ``neigh_modify every 5 delay 0 check no`` so that
10 steps cross the re-bins of steps 5 and 10 (the migration carries the
tag-matched tables, ``tpumd_torch/ops/cellgrid_tuples.py``):

* replicated 2x2x2 (3,000 atoms, a 4^3 cell grid) on the grid as 4 z-slabs
  and as 2, and on the matrix engine's row blocks (``RowDecomp``) on 4 and
  2 ranks; replicated 2x2x1 (a 4x4x2 grid) as 2 x 2 (z, y) pencils, where
  each z halo of a rank holds the other z block's plane (the same atoms a
  box length apart): x and v by tag equal the port's one-rank run to
  1e-10, and the thermo rows to 1e-10;
* the 2x2x2 decks equal tpumd's sharded run on the 8 virtual devices
  (``tests/test_bonded_grid.py:160-245``, ``test_slab_halo.py:99-123``) by
  tag to 1e-10;
* B5 runs its owned-rows variant once a force evaluation on each rank (its
  plain version here); between output steps a grid step makes no
  all-gather: one halo round of positions (and SHAKE's velocities and
  forces) a split axis and pppm's one all-reduce of its mesh, whose bytes
  are the mesh's; the matrix engine all-gathers the rows' positions (and
  SHAKE's x, v and f) instead.

Every world is spawned once for the module (``parallel/launch.py``).
"""

import os

import numpy as np
import pytest
import torch

from tpumd_torch.parallel.launch import run_decks, spawn_world, tag_order
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
STEPS = 10
REBIN = "neigh_modify    every 5 delay 0 check no"


def deck(name, rep):
    """The golden deck replicated rep, re-binned every 5 steps, without
    its dump and run lines."""
    with open(os.path.join(GOLDEN, name, "in.test")) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if not ln.startswith(("dump", "run"))]
    out = []
    for ln in lines:
        out.append(REBIN if ln.startswith("neigh_modify") else ln)
        if ln.startswith("read_data"):
            out.append(f"replicate {rep}")
    return "\n".join(out) + "\n"


def spec(name, rep, mode="cellgrid", steady=0):
    return {"setup": deck(name, rep), "mode": mode,
            "runs": [f"run {STEPS}"], "steady": steady,
            "data_dir": os.path.join(GOLDEN, name)}


# name: (ranks, golden, replicate, engine, processor grid or None)
RUNS = {"nve_slabs": (4, "water_nve", "2 2 2", "cellgrid", (4, 1)),
        "shake_slabs": (4, "water_shake", "2 2 2", "cellgrid", (4, 1)),
        "nve_pencils": (4, "water_nve", "2 2 1", "cellgrid", (2, 2)),
        "shake_pencils": (4, "water_shake", "2 2 1", "cellgrid", (2, 2)),
        "shake_matrix": (4, "water_shake", "2 2 2", "matrix", None),
        "nve_two": (2, "water_nve", "2 2 2", "cellgrid", (2, 1)),
        "shake_two": (2, "water_shake", "2 2 2", "cellgrid", (2, 1)),
        "nve_matrix": (2, "water_nve", "2 2 2", "matrix", None)}
STEADY = 4
COUNTED = {"shake_slabs", "shake_pencils", "nve_two", "shake_matrix"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{name: [each rank's run_deck result]}."""
    d = tmp_path_factory.mktemp("molecular")
    out = {}
    for nprocs in (4, 2):
        names = [k for k, v in RUNS.items() if v[0] == nprocs]
        specs = [spec(*RUNS[k][1:4], steady=STEADY if k in COUNTED else 0)
                 for k in names]
        ranks = spawn_world(run_decks, nprocs, "gloo", d / f"pg{nprocs}",
                            (specs,), timeout=400)
        for k, name in enumerate(names):
            out[name] = [r[k] for r in ranks]
    return out


@pytest.fixture(scope="module")
def one_rank():
    """{(golden, replicate): (x, v, thermo rows)} of the port's run on one
    card (the tag-order view of the bonded styles)."""
    out = {}
    for _, name, rep, _, _ in RUNS.values():
        if (name, rep) in out:
            continue
        s = spec(name, rep)
        script = LammpsScript(device="cpu", dtype=torch.float64)
        script.data_dir = s["data_dir"]
        script.run_string(s["setup"])
        sim = script.sim
        sim.verbose = False
        sim.neighbor_mode = "cellgrid"
        script.run_string(s["runs"][0])
        assert not sim._ctx.bonded_grid
        x, v = tag_order(sim.state, "x", "v")
        out[(name, rep)] = (x, v, list(sim.thermo_rows))
    return out


@pytest.fixture(scope="module")
def tpumd_sharded():
    """{golden: (x, v) by tag} of tpumd's 2x2x2 deck, ``bonded_grid`` on
    the cell grid, 10 steps sharded over the 8 virtual devices."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from tpumd.md.verlet import run_segment
    from tpumd.parallel.mesh import make_mesh, shard_carry
    from tpumd.script.parser import LammpsScript as JScript
    out = {}
    for name in ("water_nve", "water_shake"):
        script = JScript(data_dir=os.path.join(GOLDEN, name))
        script.run_string(deck(name, "2 2 2"))
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
        tag = np.asarray(s.tag)
        keep = np.nonzero(tag > 0)[0]
        order = keep[np.argsort(tag[keep])]
        out[name] = (np.asarray(s.x)[order], np.asarray(s.v)[order])
    return out


THERMO_KEYS = ("temp", "epair", "emol", "etotal", "press")


@pytest.mark.parametrize("name", RUNS)
def test_decomposed_water_equals_the_one_rank_run(name, worlds, one_rank):
    nprocs, golden, rep, mode, layout = RUNS[name]
    x, v, rows = one_rank[(golden, rep)]
    ranks = worlds[name]
    assert len(ranks) == nprocs
    for r in ranks:
        if layout is not None:
            assert (r["layout"]["pz"], r["layout"]["py"]) == layout
        np.testing.assert_allclose(r["x"], x, rtol=0, atol=1e-10)
        np.testing.assert_allclose(r["v"], v, rtol=0, atol=1e-10)
        assert [a["step"] for a in r["rows"]] == [0, 5, 10]
        for a, b in zip(r["rows"], rows):
            for k in THERMO_KEYS:
                assert a[k] == pytest.approx(b[k], rel=1e-10, abs=1e-10), k
        # the set-up's build and one a re-bin, more than one of them
        assert r["nbuilds"] >= 3


@pytest.mark.parametrize("name", ["nve_slabs", "shake_slabs", "shake_matrix",
                                  "nve_matrix"])
def test_decomposed_water_equals_tpumd_sharded(name, worlds, tpumd_sharded):
    golden = RUNS[name][1]
    x, v = tpumd_sharded[golden]
    for r in worlds[name]:
        np.testing.assert_allclose(r["x"], x, rtol=0, atol=1e-10)
        np.testing.assert_allclose(r["v"], v, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["nve_slabs", "shake_pencils", "nve_two"])
def test_b5_rows_once_a_force_evaluation(name, worlds):
    # the set-up, the steps, and the rows at 5 and 10
    evals = 1 + STEPS + 2
    for r in worlds[name]:
        assert r["counts"]["b5"] == (0, 0, evals)


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_steps_between_outputs_move_halos_and_the_mesh(name, worlds):
    shake = "shake" in name
    for r in worlds[name]:
        st = r["steady"]
        itemsize = r["itemsize"]
        # pppm's mesh, summed once a force evaluation
        assert st["calls"]["all_reduce"] == STEADY
        mesh = st["bytes"]["all_reduce"] // STEADY
        assert mesh % itemsize == 0 and mesh // itemsize >= 1000
        if RUNS[name][3] == "matrix":
            width = int(np.ceil(r["natoms"] / RUNS[name][0]))
            # the rows' positions, and SHAKE's x, v and f
            assert st["calls"] == {"exchange": 0, "all_reduce": STEADY,
                                   "all_gather": STEADY * (1 + shake)}
            assert st["bytes"]["all_gather"] == STEADY * RUNS[name][0] * \
                width * (3 + 9 * shake) * itemsize
            continue
        assert st["calls"]["all_gather"] == 0
        nz, ny, nx, cap = r["layout"]["local"]
        pz, py = r["layout"]["pz"], r["layout"]["py"]
        plane = 3 * itemsize * nx * cap
        per_step = (2 * ny * plane if pz > 1 else 0) + \
            (2 * nz * plane if py > 1 else 0)
        rounds = (pz > 1) + (py > 1)
        assert st["calls"]["exchange"] == STEADY * rounds * (1 + shake)
        assert st["bytes"]["exchange"] == STEADY * per_step * (1 + 2 * shake)


def test_water_shake30k_is_the_golden_replicated():
    """bench_targets.IN_WATER_SHAKE30K: tests/golden/water_shake/in.test
    with ``replicate 4 4 5`` after read_data, thermo 50, its dump and run
    lines dropped."""
    from tpumd_torch.bench_targets import IN_WATER_SHAKE30K
    with open(os.path.join(GOLDEN, "water_shake", "in.test")) as fh:
        want = [ln.replace("data.water", "{golden}/data.water")
                for ln in fh.read().splitlines()
                if ln.strip() and not ln.startswith(("dump", "run"))]
    got = [ln for ln in IN_WATER_SHAKE30K.splitlines() if ln.strip()]
    i = want.index("read_data       {golden}/data.water")
    want.insert(i + 1, "replicate       4 4 5")
    want[want.index("thermo          5")] = "thermo          50"
    assert got == want


@pytest.mark.parametrize("subset", [False, True])
def test_b5_rows_plain_equals_the_list_sweep(subset):
    """B5-rows' plain version (``charmm_rows_plain``) over every atom of
    the water_nve golden (a 2^3 grid, every pair met at its minimum image
    across the seams) equals the rowless plain sweep to 1e-12 of max|f| in
    f64, energies and virial included; over a subset of the rows, those
    rows' forces equal it and the others are 0."""
    from tpumd_torch.ops.charmm_cellgrid import charmm_pairlist_plain
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.data_dir = os.path.join(GOLDEN, "water_nve")
    script.run_string(deck("water_nve", "1 1 1"))
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    script.run_string("run 0")
    s, neigh, _ = sim._carry
    c = sim.pair.kernel_coeffs(s.x, *sim._special_weights())
    args = (s.x, s.q, s.type, neigh.pairs, neigh.npairs, s.box, c)
    want = charmm_pairlist_plain(*args, True, True)
    rows = neigh.row2slot[::3] if subset else neigh.row2slot
    got = charmm_pairlist_plain(*args, True, True, rows=rows)
    scale = float(want[0].abs().max())
    np.testing.assert_allclose(got[0][rows].numpy(), want[0][rows].numpy(),
                               rtol=0, atol=1e-12 * scale)
    off = torch.ones(s.x.shape[0], dtype=torch.bool)
    off[rows] = False
    assert not bool(got[0][off].any())
    if not subset:
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(b.abs().max()))
