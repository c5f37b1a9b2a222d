"""EAM on the matrix engine: eam with two funcfl files, two-element
eam/alloy, eam/fs and eam/he, and adp, against tpumd on the CPU in float64;
the engine that "auto" picks; single-element eam on both engines.

The potentials are generated: ``bench_targets.eam_funcfl`` (the Cu-like
funcfl; a second file samples the same functions on other grids, so
file2array re-interpolates both) and ``bench_targets.alloy_setfl`` (two
elements whose cross terms differ from the like ones).  The state is
tests/test_manybody.py's ALCU_DECK cell (4^3 fcc at 4.05 A, the half with
x < 2 cells type 2), moved off the lattice by ``displace_atoms random``.
Each style's forces, energy and virial through both packages' ``compute``
on the port's neighbor rows hold to 1e-12 relative, and a 10-step NVE deck
prints the same rows in both.
"""

import os

import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.models.registry import create_pair_style as j_create
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

CELL = """units metal
atom_style atomic
lattice fcc 4.05
region box block 0 4 0 4 0 4
create_box 2 box
create_atoms 1 box
region half block 0 2 0 4 0 4
group cu region half
set group cu type 2
"""
MOVE = "displace_atoms all random 0.1 0.1 0.1 4711 units box\n"
NVE = """velocity all create 600.0 376847 loop geom
neighbor 1.0 bin
neigh_modify every 1 delay 5 check yes
fix 1 all nve
timestep 0.001
thermo 5
run 10
"""
# rho of the state spans about 0.8-1.2: eam/he's table from 0.9 puts some
# atoms on its below-table extrapolation
HE_RHOMIN = 0.9


def write_files(d):
    bt.eam_funcfl(os.path.join(d, "Cu.eam"))
    bt.eam_funcfl(os.path.join(d, "Cu2.eam"), nrho=450, drho=0.0056,
                  nr=480, dr=0.0104)
    bt.alloy_setfl(os.path.join(d, "CuAl.eam.alloy"))
    bt.alloy_setfl(os.path.join(d, "CuAl.eam.fs"), fs=True)
    bt.alloy_setfl(os.path.join(d, "CuAl.eam.he"), he_rhomin=HE_RHOMIN)
    bt.alloy_setfl(os.path.join(d, "CuAl.adp"), adp=True)


# style -> pair_coeff lines [(i, j, file, elements...)]
STYLES = {
    "eam": [("1", "1", "Cu.eam"), ("2", "2", "Cu2.eam")],
    "eam/alloy": [("*", "*", "CuAl.eam.alloy", "Al", "Cu")],
    "eam/fs": [("*", "*", "CuAl.eam.fs", "Al", "Cu")],
    "eam/he": [("*", "*", "CuAl.eam.he", "Al", "Cu")],
    "adp": [("*", "*", "CuAl.adp", "Al", "Cu")],
}


def deck_of(style, d, tail):
    lines = "".join(f"pair_coeff {i} {j} {os.path.join(d, f)} "
                    f"{' '.join(el)}\n" for i, j, f, *el in STYLES[style])
    mass = "mass * 63.55\n" if style == "eam" else ""
    return CELL + mass + f"pair_style {style}\n" + lines + tail



def jax_compute(jpair, x, type_, box, idx, sbits, vflag):
    """tpumd's style's compute (f, evdwl, ecoul, virial) under one jax.jit:
    one compile instead of a dispatch a primitive."""
    import jax
    return jax.jit(lambda x_, t_, b_, i_, s_: jpair.compute(
        x_, t_, b_, i_, s_, None, None, True, vflag))(x, type_, box, idx,
                                                       sbits)

def close(a, b, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    return a.shape == b.shape and float(np.abs(a - b).max()) <= rel * scale


def port(deck, dtype=torch.float64, mode="auto"):
    ts = TScript(device="cpu", dtype=dtype)
    if mode == "auto":
        ts.run_string(deck)
    else:
        head, tail = deck.rsplit("run ", 1)
        ts.run_string(head)
        ts.sim.neighbor_mode = mode
        ts.run_string("run " + tail)
    return ts


@pytest.mark.parametrize("style", sorted(STYLES))
def test_matrix_compute_against_tpumd(style, tmp_path):
    import jax.numpy as jnp
    d = str(tmp_path)
    write_files(d)
    ts = port(deck_of(style, d, MOVE + "neighbor 1.0 bin\nrun 0\n"))
    sim = ts.sim
    assert sim._mode == "matrix"
    jpair = j_create(style, 2, [])
    for i, j, f, *el in STYLES[style]:
        rng = [1, 2] if i == "*" else [int(i), int(i)]
        jpair.coeff(rng[0], rng[1], rng[0], rng[1], os.path.join(d, f), *el)
    jpair.init()
    s, neigh = sim._carry[0], sim._carry[1]
    f, e, _, v = sim.pair.compute(s.x, s.type, s.box, neigh.idx,
                                  neigh.sbits, None, None, True, True)
    jf, je, _, jv = jax_compute(jpair, 
        jnp.asarray(s.x.numpy()), jnp.asarray(s.type.numpy()),
        JBox.orthogonal(s.box.lo.numpy(), s.box.hi.numpy()),
        jnp.asarray(neigh.idx.numpy()), jnp.asarray(neigh.sbits.numpy()),
        True)
    assert float(np.abs(f.numpy()).max()) > 0.05
    assert close(f.numpy(), jf), style
    assert float(e) == pytest.approx(float(je), rel=1e-12)
    assert close(v.numpy(), jv), style
    if style == "eam/he":
        # some hosts sit below the table: the extrapolation is exercised
        rho = _host_density(sim)
        assert float(rho.min()) < HE_RHOMIN < float(rho.max())


def _host_density(sim):
    """rho_i of the port's eam/he state (pass 1 alone)."""
    pair = sim.pair
    s, neigh = sim._carry[0], sim._carry[1]
    _, _, inside, m, p, it, jt = pair._pass_geometry(
        s.x, s.type, s.box, neigh.idx, pair.cutforcesq)
    t2rhor = pair._index_table("type2rhor", s.x)
    c = pair._rows("rhor", t2rhor[jt, it], m, s.x, pair.nr)
    return torch.sum(torch.where(inside, pair._val(c, p), 0.0), dim=1)


@pytest.mark.parametrize("style", ["eam/alloy", "adp", "eam/he"])
def test_matrix_deck_rows_against_tpumd(style, tmp_path):
    d = str(tmp_path)
    write_files(d)
    deck = deck_of(style, d, NVE)
    js = JScript()
    js.run_string(deck)
    ts = port(deck)
    rows = [[ln for ln in sim.log_lines if not ln.startswith(
        ("Loop time", "Performance", "Neighbor"))] for sim in (js.sim,
                                                             ts.sim)]
    assert len(rows[1]) == 4 and rows[1] == rows[0]


def test_single_element_both_engines(tmp_path):
    """One-element eam: the grid's B3/B4 (plain versions here) and the
    matrix engine agree at step 0 to 1e-10."""
    pot = os.path.join(tmp_path, "Cu.eam")
    bt.eam_funcfl(pot)
    deck = bt.IN_EAM.format(n=4, potential=pot) + MOVE + "run 0\n"
    grid, matrix = port(deck), port(deck, mode="matrix")
    assert grid.sim._mode == "cellgrid" and matrix.sim._mode == "matrix"

    def by_tag(sim):
        # the grid's state holds empty slots (tag 0)
        tag = sim.state.tag.numpy()
        return sim.state.f.numpy()[tag > 0][np.argsort(tag[tag > 0])]
    assert close(by_tag(matrix.sim), by_tag(grid.sim), rel=1e-10)
    for k in ("epair", "press"):
        assert matrix.sim.last_thermo[k] == pytest.approx(
            grid.sim.last_thermo[k], rel=1e-10), k


ENGINE_CASES = {
    # name -> (deck lines after the pair style's set-up, engine or error)
    "one type": ("", "cellgrid"),
    "two types": ("two", "matrix"),
    "non-periodic": ("boundary", "matrix"),
    "exclude": ("exclude", "matrix"),
    "forced grid, two types": ("two grid", "the EAM cell-grid kernels"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_auto_engine(case, tmp_path):
    """"auto" keeps one-element EAM in a periodic box on the grid and
    sends several types, a non-periodic axis and neigh_modify exclude to
    the matrix engine; a forced cellgrid with several types raises."""
    what, want = ENGINE_CASES[case]
    pot = os.path.join(tmp_path, "Cu.eam")
    bt.eam_funcfl(pot)
    boundary = "boundary p p f\n" if "boundary" in what else ""
    ntypes = 2 if "two" in what else 1
    deck = (f"units metal\natom_style atomic\n{boundary}lattice fcc 3.615\n"
            f"region box block 0 4 0 4 0 4\ncreate_box {ntypes} box\n"
            "create_atoms 1 box\n"
            + ("region half block 0 2 0 4 0 4\nset region half type 2\n"
               if ntypes == 2 else "")
            + "region corner block 0 1 0 1 0 1\ngroup low region corner\n"
            + f"pair_style eam\npair_coeff * * {pot}\nneighbor 1.0 bin\n"
            + ("neigh_modify exclude group low low\n"
               if "exclude" in what else "") + "run 0\n")
    if want in ("cellgrid", "matrix"):
        ts = port(deck)
        assert ts.sim._mode == want
        assert np.isfinite(ts.sim.last_thermo["epair"])
    else:
        with pytest.raises(NotImplementedError, match=want):
            port(deck, mode="cellgrid")


@pytest.mark.parametrize("style,engine", [("eam/he", "matrix"),
                                          ("adp", "matrix")])
def test_matrix_only_styles(style, engine, tmp_path):
    """eam/he and adp run on the matrix engine only: "auto" picks it for
    one type in a periodic box, and a forced cellgrid raises."""
    d = str(tmp_path)
    write_files(d)
    f = STYLES[style][0][2]
    deck = (bt.IN_EAM.format(n=4, potential=os.path.join(d, f) + " Cu")
            .replace("pair_style      eam", f"pair_style      {style}")
            .replace("pair_coeff      1 1", "pair_coeff      * *")
            + "run 0\n")
    assert port(deck).sim._mode == engine
    with pytest.raises(NotImplementedError, match="cell grid"):
        port(deck, mode="cellgrid")


def test_eamalloy32k_cell_gate_values(tmp_path):
    """IN_EAMALLOY32K's step-0 gate: the 256-atom cell's pe per atom and
    virial pressure from tpumd (bench_targets.EAMALLOY_CELL_STEP0), which
    the port's cell matches to 1e-12."""
    pot = os.path.join(tmp_path, "CuAl.eam.alloy")
    bt.alloy_setfl(pot)
    deck = bt.IN_EAMALLOY.format(n=1, potential=pot) + "run 0\n"
    js = JScript()
    js.run_string(deck)
    ts = port(deck)
    for sim in (js.sim, ts.sim):
        got = bt.mb32k_step0(sim.last_thermo, sim.natoms, float(
            np.prod(np.asarray(sim.state.box.lengths))))
        assert not bt.mb32k_step0_failures(got, bt.EAMALLOY_CELL_STEP0,
                                           1e-12)


def test_eamalloy_f32_cpu_gaps(tmp_path):
    """The f32 gaps that IN_EAMALLOY32K's f32 gate scales
    (bench_targets.EAMALLOY_F32_CPU_GAP, per column the larger of the
    256-atom cell's and the 32k deck's, probes/mb32k_cpu_gaps.py): the
    cell's lie under it."""
    pot = os.path.join(tmp_path, "CuAl.eam.alloy")
    bt.alloy_setfl(pot)
    deck = bt.IN_EAMALLOY.format(n=1, potential=pot)

    def make(dtype):
        ts = TScript(device="cpu", dtype=dtype)
        ts.run_string(deck)
        return ts
    gaps = bt.mb32k_f32_gaps(make, steps=100)
    for k, g in gaps.items():
        assert g <= bt.EAMALLOY_F32_CPU_GAP[k], (k, g)


@pytest.mark.parametrize("style", ["eam/alloy", "sw"])
def test_peratom_tallies_raise(style, tmp_path):
    """compute pe/atom with a style that has no per-atom tallies raises
    and names the style (tpumd has none either)."""
    d = str(tmp_path)
    write_files(d)
    if style == "sw":
        pot = bt.write_potential(d, "Si.sw")
        deck = ("units metal\natom_style atomic\nlattice diamond 5.431\n"
                "region box block 0 3 0 3 0 3\ncreate_box 1 box\n"
                "create_atoms 1 box\nmass 1 28.06\npair_style sw\n"
                f"pair_coeff * * {pot} Si\n")
    else:
        deck = deck_of(style, d, "")
    deck += "compute pe all pe/atom\nthermo_style custom step c_pe[1]\n"
    with pytest.raises(ValueError, match=f"pair style '{style}'"):
        port(deck + "run 0\n")
