"""The thermostats and barostats decomposed over gloo ranks on the CPU, in
f64 (ROADMAP item 14d), against the port's own one-rank run, and fix
shake's tag-matched path on clusters of several sizes (C43):

* a small in.lj (6^3 fcc cells, a 3^3 grid) under fix nvt, nph (aniso, the
  MTK terms from the kinetic tensor), npt (iso) and nve + langevin (the
  "lammps" stream, and the "device" stream on the CPU's generator), 20
  steps over four re-bins, on the grid as 2 z-slabs and as 2 x 2 pencils
  and on the matrix engine's row blocks over 2 ranks;
* the peptide (``tests/golden/peptide``, a 2^3 grid of cap 368) under its
  log's styles with ``fix shake 0.0001 10 100 b 4 6 8 10 12 14 18 a 31``
  (clusters of 2, 3 and 4 atoms beside the angle clusters, ROADMAP C43)
  under fix nve, and under rhodo_class's SHAKE and z-coupled npt, each
  over 2 z-slabs of one plane (both halos of a rank are the other rank's
  plane);
* in.lj under nph with cells at the cutoff (``_baro_margin`` 1.0): the
  first segment's shrink re-validates the grid, which comes back with 3
  planes instead of 4, so the 4 ranks' z-slabs become 2 x 2 pencils;
* water_npt replicated 2x2x1 (one z plane, three y rows under the
  barostat's cell margin) on 4 ranks raises, naming the planes; minimize
  across ranks raises, naming ROADMAP item 14e.

x and v by tag, the box and the thermo rows equal the one-rank run's to
1e-10.  On one rank the peptide's tag-matched SHAKE (``bonded_grid``)
equals the tag-order view's to 1e-12, and its rows equal tpumd's
``bonded_grid`` run's to 1e-10.  Between output steps each fix's sums
over atoms go over the group in one all-reduce a call site, and the grid
makes no all-gather.  water_npt replicated 2x2x2 and the mixture of
``bench_targets.IN_SHAKE_MIXTURE`` decomposed, against tpumd's runs, are
in ``tests/test_torch_decomp_thermostats_tpumd.py``.

Every world is spawned once for the module (``parallel/launch.py``).
"""

import os

import numpy as np
import pytest
import torch

from tpumd_torch import bench_targets as bt
from tpumd_torch.parallel.launch import run_decks, spawn_world, tag_order
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REBIN = "neigh_modify    every 5 delay 0 check no"

LJ_FIXES = {
    "nvt": "fix 1 all nvt temp 1.44 1.44 0.5",
    "nph": "fix 1 all nph aniso 1.0 1.0 1.0",
    "npt": "fix 1 all npt temp 1.44 1.44 0.5 iso 1.0 1.0 1.0",
    "langevin": "fix 1 all nve\nfix 2 all langevin 1.44 1.44 1.0 48279",
    "langevin_device": "fix 1 all nve\n"
                       "fix 2 all langevin 1.44 1.44 1.0 48279",
}


def lj(fix, n=6, skin=None):
    deck = bt.IN_LJ.format(n=n).replace("every 20 check no",
                                        "every 5 check no")
    if skin is not None:
        deck = deck.replace("neighbor        0.3 bin",
                            f"neighbor        {skin!r} bin")
    return deck.replace("fix             1 all nve", fix) + "thermo 5\n"


def golden(name, rep):
    """The golden deck replicated rep, re-binned every 5 steps, without its
    dump and run lines."""
    with open(os.path.join(GOLDEN, name, "in.test")) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if not ln.startswith(("dump", "run"))]
    out = []
    for ln in lines:
        out.append(REBIN if ln.startswith("neigh_modify") else ln)
        if ln.startswith("read_data"):
            out.append(f"replicate {rep}")
    return "\n".join(out) + "\n"


PEPTIDE = f"""units           real
atom_style      full
pair_style      lj/charmm/coul/long 8.0 10.0 10.0
bond_style      harmonic
angle_style     charmm
dihedral_style  charmm
improper_style  harmonic
kspace_style    pppm 0.0001
read_data       {GOLDEN}/peptide/data.peptide
replicate       {{rep}}
neighbor        2.0 bin
{REBIN}
timestep        2.0
thermo          5
{{fixes}}
"""
# the re-anchor's deck (ROADMAP C43) unreplicated, and rhodo_class's fix
# lines
PEPTIDE_NVE = PEPTIDE.format(rep="1 1 1", fixes=(
    "fix 1 all nve\n"
    "fix 2 all shake 0.0001 10 100 b 4 6 8 10 12 14 18 a 31"))
PEPTIDE_NPT = PEPTIDE.format(rep="1 1 1", fixes=(
    "fix 1 all shake 0.0001 5 0 m 1.0 a 31\n"
    "fix 2 all npt temp 300.0 300.0 100.0 z 0.0 0.0 1000.0 mtk no "
    "pchain 0 tchain 1\nspecial_bonds charmm"))
# tpumd's rows of PEPTIDE_NVE with bonded_grid on the cell grid (f64,
# CPU): (step, etotal, temp, press)
PEPTIDE_NVE_TPUMD = (
    (0, -5237.455962982735, 282.10051715233857, -836.9998980671534),
    (5, -5236.964575304414, 274.15486957032215, -700.060216090682),
    (10, -5237.70988515367, 277.739143261128, -732.073137383923))

# in.lj on 8^3 cells with cutneigh 0.05 % under a quarter of the box, the
# cells at the cutoff (margin 1.0): a 4-plane grid that any shrink
# re-validates into 3 planes
SWITCH_SKIN = 8 * (4 / 0.8442) ** (1 / 3) / 4 / 1.0005 - 2.5


def spec(setup, mode="cellgrid", steps=10, steady=0, **kw):
    return {"setup": setup, "mode": mode, "runs": [f"run {steps}"],
            "steady": steady, **kw}


STEADY = 4
# name: (ranks, processor grid or None for the row blocks, spec)
RUNS = {}
for _fix, _deck in LJ_FIXES.items():
    _kw = ({"fix_attrs": {"2": {"rng": "device"}}}
           if _fix == "langevin_device" else {})
    for _lay, (_p, _grid, _mode) in {"two": (2, (2, 1), "cellgrid"),
                                     "four": (4, (2, 2), "cellgrid"),
                                     "rows": (2, None, "matrix")}.items():
        RUNS[f"lj_{_fix}_{_lay}"] = (_p, _grid, spec(
            lj(_deck), _mode, 20, STEADY if _lay != "two" else 0, **_kw))
RUNS.update({
    "peptide_nve_slabs": (2, (2, 1), spec(PEPTIDE_NVE)),
    "peptide_npt_slabs": (2, (2, 1), spec(PEPTIDE_NPT)),
    "lj_nph_relayout": (4, (2, 2), spec(
        lj("fix 1 all nph iso 8.0 8.0 0.5", n=8, skin=SWITCH_SKIN),
        steps=20, attrs={"_baro_margin": 1.0})),
})
# name: (ranks, spec, what the message says)
REFUSALS = {
    "water_npt_one_plane": (4, spec(
        golden("water_npt", "2 2 1"),
        data_dir=os.path.join(GOLDEN, "water_npt"), refusal="z planes"),
        ("1 z planes and 3 y rows", "4 ranks cannot be laid out")),
    "minimize": (4, {"setup": lj(LJ_FIXES["nvt"]),
                     "runs": ["minimize 1e-4 1e-6 10 100"],
                     "refusal": "14e"},
                 ("command minimize across 4 ranks", "ROADMAP item 14e")),
}


def spawn_worlds(d, table):
    """{name: [each rank's run_deck result]} of table {name: (ranks,
    spec)}, a world for each rank count."""
    out = {}
    for nprocs in sorted({p for p, _ in table.values()}, reverse=True):
        names = [k for k, (p, _) in table.items() if p == nprocs]
        ranks = spawn_world(run_decks, nprocs, "gloo", d / f"pg{nprocs}",
                            ([table[k][1] for k in names],), timeout=400)
        for k, name in enumerate(names):
            out[name] = [r[k] for r in ranks]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return spawn_worlds(tmp_path_factory.mktemp("thermostats"), {
        **{k: (p, s) for k, (p, _, s) in RUNS.items()},
        **{k: (p, s) for k, (p, s, _) in REFUSALS.items()}})


def one_rank(s, bonded_grid=False):
    """x, v by tag, the thermo rows, the box and the simulation of the
    port's run of spec s on one card."""
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.data_dir = s.get("data_dir", ".")
    script.run_string(s["setup"])
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = s["mode"]
    sim.bonded_grid = bonded_grid
    for name, value in s.get("attrs", {}).items():
        setattr(sim, name, value)
    for fx in sim.fixes:
        for name, value in s.get("fix_attrs", {}).get(
                getattr(fx, "id", None), {}).items():
            setattr(fx, name, value)
    for piece in s["runs"]:
        script.run_string(piece)
    x, v = tag_order(sim.state, "x", "v")
    return {"x": x, "v": v, "rows": list(sim.thermo_rows),
            "box": sim.state.box.lengths_np(), "sim": sim}


def _key(s):
    """What a one-rank run of spec s depends on."""
    return repr({k: s.get(k) for k in ("setup", "mode", "runs", "attrs",
                                       "fix_attrs", "data_dir")})


@pytest.fixture(scope="module")
def refs():
    """{name: one_rank of RUNS[name]'s spec} (a run each distinct spec),
    and {"peptide_grid": the C43 deck with ``bonded_grid`` on}."""
    out, runs = {}, {}
    for name, (_, _, s) in RUNS.items():
        key = _key(s)
        if key not in runs:
            runs[key] = one_rank(s)
        out[name] = runs[key]
    out["peptide_grid"] = one_rank(RUNS["peptide_nve_slabs"][2],
                                   bonded_grid=True)
    return out


THERMO_KEYS = ("temp", "epair", "emol", "etotal", "press", "vol")


def assert_same_run(got, want, atol=1e-10, rtol=1e-10):
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["box"], want["box"], rtol=rtol, atol=0)
    assert [a["step"] for a in got["rows"]] == \
        [b["step"] for b in want["rows"]]
    for a, b in zip(got["rows"], want["rows"]):
        for k in THERMO_KEYS:
            assert a[k] == pytest.approx(b[k], rel=rtol, abs=rtol), (
                a["step"], k)


@pytest.mark.parametrize("name", RUNS)
def test_decomposed_run_equals_the_one_rank_run(name, worlds, refs):
    nprocs, grid, s = RUNS[name]
    ranks = worlds[name]
    assert len(ranks) == nprocs
    for r in ranks:
        if grid is None:
            assert "layout" not in r
        else:
            assert (r["layout"]["pz"], r["layout"]["py"]) == grid
        assert_same_run(r, refs[name])
        assert r["nbuilds"] >= 3
    if any(k in s["setup"] for k in ("nph", "npt")):
        # the barostat moved the box
        rows = refs[name]["rows"]
        assert rows[-1]["vol"] != rows[0]["vol"]


def test_the_barostat_re_lays_the_grid_out(worlds, refs):
    """The first segment's shrink leaves the 4-plane grid's cells under
    the cutoff: the re-validation's grid has 3 planes, and the 4 ranks'
    z-slabs become 2 x 2 pencils (the layout asserted by the parametrised
    test above)."""
    ref = refs["lj_nph_relayout"]
    assert ref["sim"].grid_setups == 2 and ref["sim"]._neigh_cfg.nz == 3
    for r in worlds["lj_nph_relayout"]:
        assert r["grid_setups"] == 2
        assert r["layout"]["local"][0] in (3, 4)


@pytest.mark.parametrize("name", REFUSALS)
def test_what_cannot_run_across_ranks_raises(name, worlds):
    for r in worlds[name]:
        for what in REFUSALS[name][2]:
            assert what in r["refused"]
        assert "14b" not in r["refused"]


def test_tag_matched_shake_equals_the_tag_order_view(refs):
    """C43: clusters of 2, 3 and 4 atoms and angle clusters on the
    tag-matched path, on one rank, equal the tag-order view's solve to
    1e-12."""
    on, off = refs["peptide_grid"], refs["peptide_nve_slabs"]
    assert on["sim"]._ctx.bonded_grid and not off["sim"]._ctx.bonded_grid
    assert all(on["sim"].shake_fixes()[0].counts())
    assert_same_run(on, off, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("which", ["peptide_grid", "peptide_nve_slabs"])
def test_the_peptide_rows_are_tpumds(which, refs, worlds):
    runs = [refs[which]] + (worlds[which] if which in worlds else [])
    for r in runs:
        assert len(r["rows"]) == len(PEPTIDE_NVE_TPUMD)
        for row, (step, etotal, temp, press) in zip(r["rows"],
                                                     PEPTIDE_NVE_TPUMD):
            assert row["step"] == step
            assert row["etotal"] == pytest.approx(etotal, rel=1e-10)
            assert row["temp"] == pytest.approx(temp, rel=1e-10)
            assert row["press"] == pytest.approx(press, rel=1e-10)


# (all-reduces, float64 words) a step between output steps of each fix:
# fix nvt's temperature at each half; a barostat's temperature, kinetic
# tensor (3) and the step's virial (6) in the first half, both sums in one
# in the second; langevin none
PER_STEP = {"nvt": (2, 2), "nph": (4, 14), "npt": (4, 14),
            "langevin": (0, 0)}


@pytest.mark.parametrize("name", sorted(
    k for k, (_, _, s) in RUNS.items() if s["steady"]))
def test_all_reduces_a_step_by_kind(name, worlds):
    nsteps = RUNS[name][2]["steady"]
    calls, words = PER_STEP[name.split("_")[1]]
    for r in worlds[name]:
        st = r["steady"]
        assert st["calls"]["all_reduce"] == nsteps * calls
        assert st["bytes"]["all_reduce"] == nsteps * 8 * words
        if RUNS[name][1] is None:
            # the row blocks' positions, once a step
            assert st["calls"]["all_gather"] == nsteps
            assert st["calls"]["exchange"] == 0
        else:
            assert st["calls"]["all_gather"] == 0
            assert st["calls"]["exchange"] > 0
