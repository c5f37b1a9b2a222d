"""The port's compute library against tpumd's, and its distance computes
against their plain all-pairs versions.

One two-type lj/cut melt (the matrix engine) defines every global and
per-atom compute of md/compute_styles.py, compute_pair.py,
compute_struct.py, compute_extra.py and compute_chunk.py; tpumd and the
port run it 20 steps on the CPU in float64 from the same seeded deck, and
each compute's value in tag order is compared: float columns to 1e-10 of
the array's largest value (or of 1, if that is smaller), integer columns
(counts, cluster IDs, CNA codes) exactly.  The per-atom tallies (pe/atom,
stress/atom) are compared on both engines (the grid's B1 plain version,
the matrix engine's pair_sums) against tpumd's matrix-engine tallies, and
each distance compute over its device list (the grid's list build, or the
matrix engine's) equals the same compute over the plain all-pairs sweep.
"""

import math
import os

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.md import compute_list
from tpumd_torch.md.compute_struct import ylm_table
from tpumd_torch.ops import cellgrid_pairlist
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))

HEAD = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 6 0 6 0 6
create_box      2 box
create_atoms    1 box
region          half block 0 3 INF INF INF INF
set             region half type 2
mass            * 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      * * 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    every 1 delay 0 check yes
fix             1 all nve
group           g1 type 1
group           g2 type 2
region          sub block 0 3 0 6 0 6
"""

# compute lines: (ID, rest of the line, integer-valued)
COMPUTES = [
    ("myrdf", "all rdf 50 * * 1 2", False),
    ("rdfc", "all rdf 30 cutoff 2.0", False),
    ("crd", "all coord/atom cutoff 1.5", True),
    ("crd2", "g1 coord/atom cutoff 1.5 1 2", True),
    ("cls", "all cluster/atom 1.2", True),
    ("cls2", "g1 cluster/atom 1.3", True),
    ("dsp", "all displace/atom", False),
    ("gg", "g1 group/group g2", False),
    ("kea", "all ke/atom", False),
    ("pea", "all pe/atom", False),
    ("str", "all stress/atom NULL", False),
    ("flux", "all heat/flux kea pea str", False),
    ("tmp", "all temp", False),
    ("pe", "all pe", False),
    ("ke", "all ke", False),
    ("prs", "all pressure thermo_temp", False),
    ("com", "all com", False),
    ("msd", "all msd", False),
    ("vacf", "all vacf", False),
    ("gyr", "all gyration", False),
    ("prop", "all property/atom x vy fz id type mass", False),
    ("rsum", "all reduce sum c_pea c_kea", False),
    ("rmin", "all reduce min c_pea", False),
    ("rmax", "all reduce max x", False),
    ("rave", "all reduce ave c_str[1]", False),
    ("rsq", "all reduce sumsq vx", False),
    ("tcom", "all temp/com", False),
    ("tpar", "all temp/partial 1 0 1", False),
    ("treg", "all temp/region sub", False),
    ("cna", "all cna/atom 1.3", True),
    # a cutoff near the second shell: neighbours' rows past MAXNEAR = 16
    # are capped, and a few atoms still read fcc
    ("cnaw", "all cna/atom 1.6", True),
    ("cen", "all centro/atom fcc", False),
    ("cen8", "all centro/atom 8", False),
    ("ori", "all orientorder/atom", False),
    ("ori2", "all orientorder/atom nnn NULL degrees 3 2 4 6 cutoff 1.5",
     False),
    ("tramp", "all temp/ramp vx 0 1 z 0 10", False),
    ("tprof", "all temp/profile 1 1 1 bin z 4", False),
    ("ch", "all chunk/atom type", True),
    ("chb", "all chunk/atom bin/1d x lower 2.0", True),
    ("cmc", "all com/chunk ch", False),
    ("slc", "all slice 1 3 1 c_com c_msd", False),
    ("rreg", "all reduce/region sub sum c_pea", False),
    ("spr", "all chunk/spread/atom ch c_cmc[1]", False),
    ("ga", "all global/atom c_crd c_myrdf[2]", False),
    ("rch", "all reduce/chunk chb ave c_pea", False),
    ("mom", "all momentum", False),
    ("cty", "all count/type atom", True),
    ("ng", "all msd/nongauss", False),
    ("gsh", "all gyration/shape gyr", False),
    ("pairE", "all pair lj/cut", False),
    ("pairv", "all pair lj/cut evdwl", False),
    ("ev", "all event/displace 0.5", False),
    ("dip", "all dipole", False),
]
DECK = HEAD + "".join(f"compute {cid} {rest}\n"
                      for cid, rest, _ in COMPUTES)


@pytest.fixture(scope="module")
def both():
    """tpumd's and the port's simulations after 20 steps of DECK.  tpumd's
    msd/nongauss takes its reference at its first evaluation, the port's
    (as LAMMPS's) at the first set-up (ROADMAP C16): tpumd's is evaluated
    at step 0 so that both hold the same one."""
    j = JScript()
    j.run_string(DECK + "run 0\n")
    j.sim.computes["ng"].evaluate(j.sim)
    j.run_string("run 20\n")
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(DECK + "run 0\nrun 20\n")
    return j.sim, t.sim


def close(got, want, integer, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if integer:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        # values that cancel to roundoff (a total momentum) hold to 1e-10
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale,
                                   err_msg=what)


@pytest.mark.parametrize("cid,integer",
                         [(c, i) for c, _, i in COMPUTES],
                         ids=[c for c, _, _ in COMPUTES])
def test_compute_matches_tpumd(cid, integer, both):
    jsim, tsim = both
    want = jsim.computes[cid].evaluate(jsim)
    got = tsim.computes[cid](tsim).cpu().numpy()
    close(got, want, integer, cid)
    if cid == "gg":
        close(tsim.computes[cid].vector_value(tsim).cpu().numpy(),
              jsim.computes[cid].vector, False, "gg vector")
    if cid in ("ch", "chb"):
        assert tsim.computes[cid].nchunk == jsim.computes[cid].nchunk


SINGLE = HEAD.replace("create_box      2 box", "create_box      1 box") \
    .replace("set             region half type 2\n", "") \
    .replace("group           g2 type 2\n", "") + """
compute         pea all pe/atom
compute         str all stress/atom NULL
compute         kea all ke/atom
compute         rdf all rdf 40
compute         crd all coord/atom cutoff 1.5
compute         cls all cluster/atom 1.15
compute         cna all cna/atom 1.43
compute         cen all centro/atom fcc
compute         ori all orientorder/atom
"""
DISTANCE = ("crd", "cls", "cna", "cen", "ori")


@pytest.fixture(scope="module")
def single_tpumd():
    j = JScript()
    j.run_string(SINGLE + "run 15\n")
    return j.sim


def port_single(engine):
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(SINGLE)
    t.sim.neighbor_mode = engine
    t.run_string("run 15\n")
    return t.sim


@pytest.fixture(scope="module")
def single_port():
    cache = {}

    def get(engine):
        if engine not in cache:
            cache[engine] = port_single(engine)
        return cache[engine]
    return get


@pytest.mark.parametrize("engine", ["cellgrid", "matrix"])
@pytest.mark.parametrize("cid", ["pea", "str", "kea"])
def test_tallies_both_engines(cid, engine, single_tpumd, single_port):
    """pe/atom and stress/atom from the grid's per-slot tallies and from
    pair_sums' per-row ones, against tpumd's matrix-engine tallies."""
    tsim = single_port(engine)
    assert tsim._ctx.is_cellgrid == (engine == "cellgrid")
    close(tsim.computes[cid](tsim).cpu().numpy(),
          single_tpumd.computes[cid].evaluate(single_tpumd), False, cid)


@pytest.mark.parametrize("engine", ["cellgrid", "matrix"])
@pytest.mark.parametrize("cid", DISTANCE + ("rdf",))
def test_distance_compute(cid, engine, single_tpumd, single_port):
    """Each distance compute over the occasional device list equals the
    same compute over the plain all-pairs sweep (integers exactly) and
    tpumd's value."""
    tsim = single_port(engine)
    c = tsim.computes[cid]
    builds = cellgrid_pairlist.counts.plain_calls
    lists = tsim.analysis_lists
    tsim._acache = {}
    got = c(tsim).cpu().numpy()
    assert tsim.analysis_lists == lists + 1
    if engine == "cellgrid":
        # the grid's list build (its plain version on the CPU) made it
        assert cellgrid_pairlist.counts.plain_calls == builds + 1
    c.plain = True
    try:
        plain = c.evaluate(tsim).cpu().numpy()
        if cid == "rdf":
            c.plain = False
            dev_counts = c.counts(tsim)
            c.plain = True
            assert torch.equal(dev_counts, c.counts(tsim))
    finally:
        c.plain = False
    integer = cid in ("crd", "cls", "cna")
    close(got, plain, integer, f"{cid} list vs plain")
    close(got, single_tpumd.computes[cid].evaluate(single_tpumd), integer,
          f"{cid} vs tpumd")


def test_edges_match_plain():
    """The device list's Edges equal the plain sweep's, pair for pair."""
    tsim = port_single("cellgrid")
    for rc in (1.2, 1.5, 2.5):
        a = compute_list.pair_edges(tsim, rc)
        b = compute_list.pair_edges_plain(tsim, rc)
        assert torch.equal(a.i, b.i) and torch.equal(a.j, b.j)
        assert torch.equal(a.r2, b.r2)


def test_msd_reference_by_tag_over_rebins():
    """msd's reference is taken by tag at the first set-up and survives
    re-bins and a new set-up (an unfix between runs)."""
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(SINGLE + "compute msd all msd\nrun 0\n")
    sim = t.sim
    live = sim.state.tag > 0
    ref0 = dict(zip(sim.state.tag[live].tolist(),
                    sim.state.x[live].double()))
    t.run_string("run 40\nfix 9 all nve\nunfix 9\nrun 20\n")
    assert sim.grid_setups >= 2 and sim._carry[1].nbuilds > 1
    msd = sim.computes["msd"]
    for tag, x in list(ref0.items())[:50]:
        assert torch.equal(msd.ref.table[tag], x)
    s = sim.state
    rows = torch.nonzero(s.tag > 0).flatten()
    xu = s.x[rows].double() + s.image[rows].double() * s.box.lengths
    d = xu - msd.ref.table[s.tag[rows].long()]
    want = (d * d).mean(0)
    got = msd(sim)
    assert torch.allclose(got[:3], want, rtol=1e-13, atol=0)


POUR = open(os.path.join(HERE, "golden", "gran", "in.pour")).read().split(
    "run")[0] + "compute msd all msd\ncompute dsp all displace/atom\n"


def test_msd_reference_through_pour():
    """fix pour's atoms (48 at the first run's start, 17 more at step 107)
    get their reference when first seen; the atoms already there keep
    theirs (kept by tag) through the insertion's new set-up."""
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(POUR + "run 0\n")
    sim = t.sim
    assert sim.natoms == 48
    msd = sim.computes["msd"]
    msd(sim)
    first = msd.ref.table[1:49].clone()
    t.run_string("run 107\n")
    assert sim.natoms == 65
    got = msd(sim)
    assert torch.equal(msd.ref.table[1:49], first)
    assert bool(msd.ref.known[1:66].all())
    assert torch.isfinite(got).all() and float(got[3]) > 0
    assert sim.computes["dsp"](sim).shape == (65, 4)


def test_ylm_matches_scipy():
    """The normalized associated Legendre recurrence gives scipy's
    |Y_lm| (tpumd's sph_harm_y) to 1e-13."""
    from scipy.special import sph_harm_y
    rng = np.random.default_rng(5)
    theta = rng.uniform(0, math.pi, 64)
    y = ylm_table(torch.as_tensor(np.cos(theta)), 12)
    for l in range(13):
        for m in range(l + 1):
            want = np.abs(sph_harm_y(l, m, theta, 0.0))
            np.testing.assert_allclose(np.abs(y[l, m].numpy()), want,
                                       rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("line,match", [
    ("compute c all pair/local dist", "pair/local"),
    ("compute c all temp/asphere", "temp/asphere"),
    ("compute c all stress/atom NULL ke", "stress/atom"),
    ("compute c all orientorder/atom wl yes", "orientorder"),
    ("compute c all chunk/atom bin/2d x lower 1 y lower 1", "chunk/atom"),
    ("fix f all ave/grid 1 1 1 2 2 2 c_x", "ave/grid"),
    ("fix f all neb 1.0 parallel ideal", "neb"),
    ("fix f all balance 100 1.1 shift x 10 1.1", "balance"),
    ("fix f all ave/time 1 1 1 c_thermo_temp ave running", "ave/time"),
    ("fix f all ave/histo 1 1 1 0 1 10 vx ave running", "ave/histo"),
    ("fix f all property/atom mol", "property/atom"),
    ("fix f all store/state 0 x com yes", "store/state"),
    ("fix f all deform 1 x final 0 10", "deform"),
])
def test_unported_raise(line, match):
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(SINGLE)
    with pytest.raises(NotImplementedError, match=match):
        t.run_string(line)


def test_peratom_on_eam_raises(tmp_path):
    from tpumd_torch.bench_targets import IN_EAM, eam_funcfl
    eam_funcfl(str(tmp_path / "Cu.eam"))
    deck = IN_EAM.format(n=4, potential=str(tmp_path / "Cu.eam"))
    deck = deck.split("\nrun")[0] + "\ncompute pea all pe/atom\n"
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    with pytest.raises(ValueError, match="eam"):
        t.run_string("run 0")


SPHERES = open(os.path.join(HERE, "golden", "gran", "in.granwall")).read() \
    .rsplit("run", 1)[0] + """
group           low region slab
compute         ts all temp/sphere
compute         tsr all temp/sphere dof rotate
compute         ers all erotate/sphere/atom
compute         er2 low erotate/sphere
"""


@pytest.mark.parametrize("cid", ["rot", "ts", "tsr", "ers", "er2"])
def test_sphere_computes_match_tpumd(cid, sphere_runs):
    """erotate/sphere, temp/sphere and erotate/sphere/atom on the granwall
    golden after 150 steps (spheres spinning on the wall)."""
    jsim, tsim = sphere_runs
    close(tsim.computes[cid](tsim).cpu().numpy(),
          jsim.computes[cid].evaluate(jsim), False, cid)


@pytest.fixture(scope="module")
def sphere_runs():
    j = JScript()
    j.run_string(SPHERES + "run 150\n")
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(SPHERES + "run 150\n")
    return j.sim, t.sim
