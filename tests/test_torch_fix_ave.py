"""The port's output fixes and per-atom tallies against tpumd.

The analysis decks of tests/test_observability.py run through the port
(per-atom tallies summing to the globals on both engines, fix ave/time and
ave/chunk files, fix print and halt, a FENE chain's bonded tallies), and a
deck with every output fix (ave/time scalar and vector, ave/atom,
ave/histo, ave/correlate, store/state, property/atom with set, print to a
file) and a dump custom of c_, f_, v_, d_ and i_ columns runs through
tpumd and the port on the CPU in float64: the files' header lines are
equal and their numbers agree to 1e-9 (they print 6 to 10 digits).  The
charmm deck's tallies (B5's plain version) sum to the pair and bonded
energies, without kspace (ROADMAP C15).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import IN_CHAIN, chain_data
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))

HEAD = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 5 0 5 0 5
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 5 check no
fix             1 all nve
"""


def port(extra, nsteps=10, engine="auto", data_dir=None):
    s = TScript(device="cpu", dtype=torch.float64)
    if data_dir:
        s.data_dir = data_dir
    s.run_string(HEAD + extra)
    s.sim.neighbor_mode = engine
    s.run_string(f"run {nsteps}\n")
    return s


@pytest.mark.parametrize("engine", ["cellgrid", "matrix"])
def test_peratom_tallies_sum_to_globals(engine):
    """tests/test_observability.py's deck on each engine."""
    s = port("""
compute pea all pe/atom
compute st all stress/atom NULL
compute kea all ke/atom
compute red all reduce sum c_pea
""", engine=engine)
    sim = s.sim
    assert sim._ctx.is_cellgrid == (engine == "cellgrid")
    v = sim.thermo_values()
    eatom = sim.computes["pea"](sim).numpy()
    assert eatom.sum() == pytest.approx(v["epair"] * sim.natoms, rel=1e-10)
    assert float(sim.computes["red"](sim)) == pytest.approx(eatom.sum())
    st = sim.computes["st"](sim).numpy()
    assert -st[:, :3].sum() / (3.0 * v["vol"]) == pytest.approx(
        v["press"], rel=1e-8)
    kea = sim.computes["kea"](sim).numpy()
    assert kea.sum() == pytest.approx(v["ke"] * sim.natoms, rel=1e-10)


def test_ave_time_and_chunk(tmp_path):
    """tests/test_observability.py's deck; the files equal tpumd's."""
    deck = """
compute myT all temp
compute ch all chunk/atom bin/1d z lower 2.0
fix at all ave/time 2 3 10 c_myT file {d}/ave.out
fix ac all ave/chunk 5 2 10 ch vx density/number file {d}/prof.out
"""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    s = port(deck.format(d=tmp_path / "t"), nsteps=20)
    j = JScript()
    j.run_string(HEAD + deck.format(d=tmp_path / "j") + "run 20\n")
    sim = s.sim
    data = np.loadtxt(tmp_path / "t" / "ave.out")
    assert data.shape == (2, 2)
    avg = sim._thermo_value(sim.thermo_values(), "f_at")
    assert np.isfinite(avg) and 0.3 < avg < 2.0
    prof = np.loadtxt(tmp_path / "t" / "prof.out")
    assert prof.shape[1] == 1 + 2 * sim.computes["ch"].nchunk
    assert prof[-1, 2::2].sum() == pytest.approx(sim.natoms)
    for name in ("ave.out", "prof.out"):
        same_file(tmp_path / "t" / name, tmp_path / "j" / name)


def test_fix_print_and_halt():
    s = port("""
variable s equal step
fix out all print 5 "step ${s} now"
fix stop all halt 2 step >= 6
""", nsteps=20)
    assert s.sim.step == 6
    assert any("step 5 now" in ln for ln in s.sim.log_lines)
    assert any("fix halt condition" in ln for ln in s.sim.log_lines)


def test_bonded_peratom_chain(tmp_path):
    """pe/atom of a FENE chain (bonds riding B2's plain version) sums to
    (epair + emol) N, and equals tpumd's per atom."""
    data = tmp_path / "data.chain"
    chain_data(str(data), natoms=2000, chain_len=50, seed=3)
    deck = IN_CHAIN.format(data=str(data)).split("\nrun")[0].split(
        "\nthermo")[0] + "\ncompute pea all pe/atom\nrun 0\n"
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    sim = t.sim
    assert sim._kernel_bond is not None and sim._ctx.is_cellgrid
    eatom = sim.computes["pea"](sim).numpy()
    v = sim.thermo_values()
    assert eatom.sum() == pytest.approx(
        (v["epair"] + v["emol"]) * sim.natoms, rel=1e-9)
    j = JScript()
    j.run_string(deck)
    want = np.asarray(j.sim.computes["pea"].evaluate(j.sim))
    np.testing.assert_allclose(eatom, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_charmm_tallies_without_kspace(tmp_path):
    """pe/atom of the water deck on the grid (B5's plain version and the
    bonded styles) sums to evdwl + ecoul + ebond + eangle, kspace's elong
    left out as tpumd leaves it (ROADMAP C15); stress/atom's virial
    likewise to the pair and bonded virial."""
    shutil.copy(os.path.join(HERE, "golden", "chunk_family", "data.water"),
                tmp_path)
    deck = open(os.path.join(HERE, "golden", "dipole", "in.dip")).read()
    deck = deck.split("compute")[0] + \
        "compute pea all pe/atom\ncompute st all stress/atom NULL\nrun 0\n"
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    t.run_string(deck)
    sim = t.sim
    assert sim._ctx.is_cellgrid and sim.kspace is not None
    e = {k: float(v) for k, v in sim._last_energies.items()}
    eatom = sim.computes["pea"](sim).numpy()
    assert eatom.sum() == pytest.approx(
        e["evdwl"] + e["ecoul"] + e["ebond"] + e["eangle"], rel=1e-10)
    assert abs(e["elong"]) > 1.0


def numbers(path):
    out = []
    for ln in open(path):
        if not ln.startswith("#"):
            out.append([float(v) for v in ln.split()])
    return out


def same_file(got, want, rtol=1e-9, expand=None):
    """Header lines equal; every number within rtol of the largest of its
    row (the files print %g, %.10g).  expand: (wildcard, its expansion) in
    want's header, which tpumd writes unexpanded and the reference binary
    (tests/golden/computes/rdf.out) and the port expanded."""
    hg = [ln for ln in open(got) if ln.startswith("#")]
    hw = [ln for ln in open(want) if ln.startswith("#")]
    if expand:
        hw = [ln.replace(*expand) for ln in hw]
    assert hg == hw, (got, hg, hw)
    a, b = numbers(got), numbers(want)
    assert len(a) == len(b), got
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        scale = max(max(abs(v) for v in rb), 1e-300)
        np.testing.assert_allclose(ra, rb, rtol=rtol, atol=1e-6 * scale,
                                   err_msg=str(got))


OUTPUT = """
compute tmp all temp
compute pe all pe
compute rdf all rdf 20
compute msd all msd
compute kea all ke/atom
fix ts all ave/time 2 5 10 c_tmp c_pe c_msd[4] file {d}/ts.out
fix tv all ave/time 5 2 10 c_rdf[*] file {d}/tv.out mode vector
fix aa all ave/atom 2 5 10 c_kea vx
fix ah all ave/histo 2 5 10 -3.0 3.0 15 vx vy file {d}/ah.out
fix ac all ave/correlate 2 4 10 c_tmp c_pe type auto/upper file {d}/ac.out
fix ss all store/state 10 xu vz
fix pp all property/atom d_w i_k
set type 1 d_w 0.5
set atom 1:100 i_k 7
run 10
dump d all custom 10 {d}/dump.out id c_kea f_aa[1] f_ss[1] f_ss[2] d_w i_k
dump_modify d sort id
"""


@pytest.fixture(scope="module")
def output_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("out")
    (d / "t").mkdir()
    (d / "j").mkdir()
    t = port(OUTPUT.format(d=d / "t"), nsteps=20)
    j = JScript()
    j.run_string(HEAD + OUTPUT.format(d=d / "j") + "run 20\n")
    return d, t, j


@pytest.mark.parametrize("name", ["ts.out", "tv.out", "ah.out", "ac.out"])
def test_output_files_equal_tpumd(name, output_runs):
    d, _, _ = output_runs
    same_file(d / "t" / name, d / "j" / name,
              expand=("c_rdf[*]", "c_rdf[1] c_rdf[2] c_rdf[3]"))


def test_dump_columns_equal_tpumd(output_runs):
    """dump custom's c_, f_ (ave/atom, store/state), d_ and i_ columns."""
    d, _, _ = output_runs
    got = open(d / "t" / "dump.out").read().split("ITEM: TIMESTEP")
    want = open(d / "j" / "dump.out").read().split("ITEM: TIMESTEP")
    assert len(got) == len(want) == 4
    for g, w in zip(got[1:], want[1:]):
        rg = np.loadtxt(g.splitlines()[9:])
        rw = np.loadtxt(w.splitlines()[9:])
        np.testing.assert_allclose(rg, rw, rtol=1e-7, atol=1e-12)
    last = np.loadtxt(got[-1].splitlines()[9:])
    assert (last[:100, 6] == 7).all() and (last[100:, 6] == 0).all()
    assert (last[:, 5] == 0.5).all()


@pytest.mark.parametrize("fid", ["ts", "tv", "aa", "ah", "ac", "ss"])
def test_fix_outputs_equal_tpumd(fid, output_runs):
    _, t, j = output_runs
    got = np.asarray(next(f for f in t.sim.fixes if f.id == fid).output(
        t.sim), np.float64)
    jf = next(f for f in j.sim.fixes if f.id == fid)
    # tpumd's ave/correlate keeps its table without an output method
    want = np.asarray(jf.output(j.sim) if hasattr(jf, "output")
                      else jf._result, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * max(np.abs(want).max(), 1.0))


def test_dump_variable_column(tmp_path):
    """dump custom v_name: an atom-style variable, by tag."""
    s = port(f"""
variable ek atom 0.5*mass*(vx*vx+vy*vy+vz*vz)
compute kea all ke/atom
dump d all custom 10 {tmp_path}/v.dump id v_ek c_kea
dump_modify d sort id format float %.15g
""", nsteps=10)
    rows = np.loadtxt(open(tmp_path / "v.dump").read().split(
        "ITEM: TIMESTEP")[-1].splitlines()[9:])
    np.testing.assert_allclose(rows[:, 1], rows[:, 2], rtol=1e-13)
    assert s.sim.natoms == len(rows)


def test_undefined_compute_in_a_dump_names_itself(tmp_path):
    """A dump's c_ column of a compute that does not exist raises at its
    first write, naming the compute (LAMMPS checks at the run's init)."""
    with pytest.raises(ValueError, match="foo"):
        port(f"dump d all custom 5 {tmp_path}/d.txt id c_foo\n", nsteps=5)
