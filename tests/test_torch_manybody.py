"""The many-body energy styles (sw, tersoff, tersoff/mod, tersoff/zbl,
vashishta, edip, atm) and their hybrids: the port against tpumd on the CPU
in float64, and against the reference binary's rows of
tests/test_manybody.py where the potential files that
``bench_targets.POTENTIALS`` writes reproduce them.

* Each style's energy, forces and virial on one seeded, perturbed state
  (3x3x3 diamond Si, or zinc-blende SiC from ``two_type_data``: 3x3x3
  cells in a box of 4 for tersoff/zbl, 2x2x2 in a box of 5 for vashishta,
  whose 7.35 A cutoff needs a box of 2 cutneigh), through both
  packages' ``compute`` on the port's neighbor rows, to 1e-10 relative:
  the virial the port builds from sum d x dE/dd against tpumd's strain
  derivative.
* A 10-step NVE deck of each through both packages: every printed row
  equal.
* The reference binary's step-10 rows (sw, tersoff, tersoff/mod, edip,
  vashishta: the written files reproduce them; tersoff/zbl's does not,
  so it is held to tpumd only).
* atm under hybrid/overlay with lj/cut on two types, a hybrid/overlay and
  a hybrid/scaled of lj/cut with sw; tersoff's bond order at zeta -> 0
  (ROADMAP C25); the f32 gaps that the card's 32k gates scale.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.models.registry import create_pair_style as j_create
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

MB2 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "manybody2")

SI_HEAD = """units metal
atom_style atomic
lattice diamond 5.431
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 28.06
"""
SIC_HEAD = """units metal
atom_style atomic
read_data {data}
"""
NVE = """velocity all create {temp} 376847 loop geom
neighbor 1.0 bin
neigh_modify every 1 delay 5 check yes
fix 1 all nve
timestep {dt}
thermo 5
"""

# style -> (state head, pair_coeff tail, two-type data (kind, n, box)
# or None, NVE temperature, timestep)
STYLES = {
    "sw": (SI_HEAD, "Si.sw Si", None, 1200.0, 0.001),
    "tersoff": (SI_HEAD, "Si.tersoff Si", None, 1200.0, 0.001),
    "tersoff/mod": (SI_HEAD, "Si.tersoff.mod Si", None, 1200.0, 0.001),
    "edip": (SI_HEAD, "Si.edip Si", None, 1200.0, 0.001),
    "tersoff/zbl": (SIC_HEAD, "SiC.tersoff.zbl Si C", (3, 4), 1800.0,
                    0.0005),
    "vashishta": (SIC_HEAD, "SiC.vashishta Si C", (2, 5), 1800.0, 0.0005),
}

# the reference binary's step-10 rows (tests/test_manybody.py: CASES,
# VARIANT_CASES and test_edip_golden) that the written files reproduce:
# style -> (deck, row)
REFERENCE_ROWS = {
    "sw": dict(temp=636.58911, epair=-921.01306, etotal=-903.32165,
               press=9572.773),
    "tersoff": dict(temp=719.04296, epair=-986.77238, etotal=-966.78951,
                    press=15660.948),
    "tersoff/mod": dict(temp=612.94474, epair=-983.72417,
                        etotal=-966.68986, press=14595.026),
    "edip": dict(temp=602.46745, epair=-987.74501, etotal=-971.00187,
                 press=-160.22024),
    "vashishta": dict(temp=1160.0759, epair=-3203.8137, etotal=-3127.1885,
                      press=54735.436),
}
# edip: the reference interpolates its grids, tpumd and the port evaluate
# the functions (tests/test_manybody.py::test_edip_golden's tolerance)
PRESS_RTOL = {"edip": 1e-2}


def write_inputs(tmp_path, style):
    head, tail, data, _, _ = STYLES[style]
    for name in bt.POTENTIALS:
        bt.write_potential(tmp_path, name)
    if data is not None:
        n, box = data
        bt.two_type_data(os.path.join(tmp_path, "data.sic"), "zincblende",
                         n, box_cells=box, displace=0.0)
    return head.format(data="data.sic"), tail


def state_deck(tmp_path, style, displace=True):
    head, tail = write_inputs(tmp_path, style)
    moved = ("displace_atoms all random 0.12 0.12 0.12 4711 units box\n"
             if displace else "")
    return (f"{head}{moved}pair_style {style}\npair_coeff * * {tail}\n"
            "neighbor 1.0 bin\n")



def jax_compute(jpair, x, type_, box, idx, sbits, vflag):
    """tpumd's style's compute (f, evdwl, ecoul, virial) under one jax.jit:
    one compile instead of a dispatch a primitive."""
    import jax
    return jax.jit(lambda x_, t_, b_, i_, s_: jpair.compute(
        x_, t_, b_, i_, s_, None, None, True, vflag))(x, type_, box, idx,
                                                       sbits)

def close(a, b, rel=1e-10):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    return a.shape == b.shape and float(np.abs(a - b).max()) <= rel * scale


def port_script(tmp_path, deck, dtype=torch.float64):
    ts = TScript(device="cpu", dtype=dtype)
    ts.data_dir = str(tmp_path)
    ts.run_string(deck)
    return ts


def tpumd_style(tsim, name, args, coeffs):
    """tpumd's style from the same arguments and pair_coeff lines."""
    jpair = j_create(name, tsim.ntypes, [_num(a) for a in args])
    for c in coeffs:
        jpair.coeff(*c)
    jpair.init()
    return jpair


def _num(tok):
    try:
        return float(tok)
    except ValueError:
        return tok


def compare_compute(tsim, jpair):
    """Both styles' (f, energy, virial) on the port's state and neighbor
    rows: the port's and tpumd's."""
    import jax.numpy as jnp
    s, neigh = tsim._carry[0], tsim._carry[1]
    f, e, _, v = tsim.pair.compute(s.x, s.type, s.box, neigh.idx,
                                   neigh.sbits, None, None, True, True)
    jbox = JBox.orthogonal(s.box.lo.numpy(), s.box.hi.numpy())
    jf, je, _, jv = jax_compute(jpair, 
        jnp.asarray(s.x.numpy()), jnp.asarray(s.type.numpy()), jbox,
        jnp.asarray(neigh.idx.numpy()), jnp.asarray(neigh.sbits.numpy()),
        True)
    return (f.numpy(), float(e), v.numpy()), (np.asarray(jf), float(je),
                                               np.asarray(jv))


@pytest.mark.parametrize("style", sorted(STYLES))
def test_energy_style_against_tpumd(style, tmp_path):
    ts = port_script(tmp_path, state_deck(tmp_path, style) + "run 0\n")
    sim = ts.sim
    assert sim._mode == "matrix"
    tail = STYLES[style][1].split()
    jpair = tpumd_style(sim, style, [],
                        [(1, sim.ntypes, 1, sim.ntypes,
                          os.path.join(str(tmp_path), tail[0]), *tail[1:])])
    (f, e, v), (jf, je, jv) = compare_compute(sim, jpair)
    assert np.all(np.isfinite(f)) and float(np.abs(f).max()) > 0.1
    assert e == pytest.approx(je, rel=1e-10)
    assert close(f, jf), style
    # the virial from sum d x dE/dd against tpumd's strain derivative: the
    # diagonal always; the off-diagonal terms where no leg crosses the box
    # (the SiC crystals sit in vacuum), since tpumd's strain moves the box
    # lengths, not the images, of a crossing leg (ROADMAP C26)
    assert close(v[:3], jv[:3]), (style, v, jv)
    if STYLES[style][2] is not None:
        assert close(v, jv), (style, v, jv)
    # the port's tensor is symmetric: xy of the state with x and y swapped
    # (-sum g_y d_x) equals its own xy (-sum g_x d_y)
    s, neigh = sim._carry[0], sim._carry[1]
    swap = [1, 0, 2]
    box = s.box
    sbox = type(box)(lo=box.lo[swap], hi=box.hi[swap],
                     periodic=box.periodic, tilt=None)
    vs = sim.pair.compute(s.x[:, swap].contiguous(), s.type, sbox,
                          neigh.idx, neigh.sbits, None, None, True,
                          True)[3].numpy()
    assert vs[3] == pytest.approx(v[3], rel=1e-10, abs=1e-10 * abs(v[0]))
    assert close(vs[:3], v[swap])


def thermo_rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance", "Neighbor"))]


@pytest.mark.parametrize("style", sorted(STYLES))
def test_nve_deck_rows_against_tpumd(style, tmp_path):
    _, _, _, temp, dt = STYLES[style]
    deck = (state_deck(tmp_path, style, displace=False)
            + NVE.format(temp=temp, dt=dt) + "run 10\n")
    js = JScript(data_dir=str(tmp_path))
    js.run_string(deck)
    ts = port_script(tmp_path, deck)
    assert ts.sim._mode == "matrix"
    jrows, trows = thermo_rows(js.sim), thermo_rows(ts.sim)
    assert len(trows) == 4 and trows == jrows
    for k in ("temp", "epair", "etotal", "press"):
        assert ts.sim.last_thermo[k] == pytest.approx(
            js.sim.last_thermo[k], rel=1e-10), k


@pytest.mark.parametrize("style", sorted(REFERENCE_ROWS))
def test_reference_binary_rows(style, tmp_path):
    """The reference binary's decks (tests/test_manybody.py) on the
    written files: the port alone against the stored rows."""
    if style == "vashishta":
        write_inputs(tmp_path, style)
        shutil.copy(os.path.join(MB2, "data.sic"), tmp_path)
        # the deck names the potential by the reference binary's path: the
        # written file beside the deck takes its place
        deck = re.sub(r"\S*/SiC\.vashishta", "SiC.vashishta",
                      open(os.path.join(MB2, "in.vash")).read())
    else:
        deck = (state_deck(tmp_path, style, displace=False)
                + NVE.format(temp=1200.0, dt=0.001) + "run 10\n")
    ts = port_script(tmp_path, deck)
    want = REFERENCE_ROWS[style]
    got = ts.sim.last_thermo
    for k in ("temp", "epair", "etotal"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert got["press"] == pytest.approx(
        want["press"], rel=PRESS_RTOL.get(style, 1e-5))


ATM_DECK = """units lj
atom_style atomic
lattice fcc 0.65
region box block 0 4 0 4 0 4
create_box 2 box
create_atoms 1 box
region half block 0 2 0 4 0 4
set region half type 2
displace_atoms all random 0.05 0.05 0.05 4711
pair_style hybrid/overlay lj/cut 2.5 atm 2.5 2.0
pair_coeff * * lj/cut 1.0 1.0
pair_coeff * * atm * 0.072
pair_coeff 1 2 atm 2 0.05
mass * 1.0
velocity all create 1.033 12345678 loop geom
neighbor 0.3 bin
neigh_modify every 1 delay 5 check yes
fix 1 all nve
timestep 0.002
thermo 5
run 10
"""


def test_atm_hybrid_against_tpumd():
    """atm at cutoff 2.5 (triple cutoff 2.0, nu set per type triplet)
    beside lj/cut on 4^3 cells of two types: every row equal."""
    js = JScript()
    js.run_string(ATM_DECK)
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(ATM_DECK)
    assert thermo_rows(ts.sim) == thermo_rows(js.sim)
    tags = ts.sim.state.tag.numpy()
    jtags = np.asarray(js.sim.state.tag)
    assert close(ts.sim.state.f.numpy()[np.argsort(tags)],
                 np.asarray(js.sim.state.f)[np.argsort(jtags)])


@pytest.mark.slow
def test_atm_golden_6cubed():
    """tests/test_manybody.py::test_atm_golden's deck (6^3 cells, K about
    400) through the port alone, against the reference binary's row."""
    deck = bt.IN_ATM_GOLDEN
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(deck)
    v = ts.sim.last_thermo
    for k, want in bt.ATM_GOLDEN_ROW.items():
        assert v[k] == pytest.approx(want, rel=1e-5 if k == "press"
                                     else 1e-6), k


HYBRID_SW = """units metal
atom_style atomic
lattice diamond 5.431
region box block 0 3 0 3 0 3
create_box 2 box
create_atoms 1 box
region half block 0 1.5 0 3 0 3
set region half type 2
mass * 28.06
displace_atoms all random 0.1 0.1 0.1 4711 units box
pair_style {ps}
pair_coeff * * lj/cut 0.01 2.0
pair_coeff * * sw {pot} Si Si
pair_coeff 1 2 lj/cut 0.02 2.1
velocity all create 1200.0 376847 loop geom
neighbor 1.0 bin
neigh_modify every 1 delay 5 check yes
fix 1 all nve
timestep 0.001
thermo 5
run 10
"""


@pytest.mark.parametrize("ps", ["hybrid/overlay lj/cut 4.0 sw",
                                "hybrid/scaled 0.5 lj/cut 4.0 0.8 sw"])
def test_hybrid_sw_lj_against_tpumd(ps, tmp_path):
    """sw over every pair and lj/cut beside it on two types, plain and
    scaled: every row equal."""
    pot = bt.write_potential(tmp_path, "Si.sw")
    deck = HYBRID_SW.format(ps=ps, pot=pot)
    js = JScript()
    js.run_string(deck)
    ts = TScript(device="cpu", dtype=torch.float64)
    ts.run_string(deck)
    assert ts.sim._mode == "matrix"
    assert thermo_rows(ts.sim) == thermo_rows(js.sim)


def test_hybrid_sw_on_own_types(tmp_path):
    """A hybrid giving sw the 1-1 pairs (type 2 mapped to NULL) and lj/cut
    at zero strength the rest: sw's masked rows hold type-1 neighbours
    only, so its energy is that of the type-1 atoms alone (the port
    against itself: tpumd's sw takes no NULL)."""
    pot = bt.write_potential(tmp_path, "Si.sw")
    head = """units metal
atom_style atomic
lattice diamond 5.431
region box block 0 3 0 3 0 3
create_box {nt} box
region half block 0 1.375 0 3 0 3
region keep block 1.375 3 0 3 0 3
mass * 28.06
"""
    hyb = port_script(tmp_path, head.format(nt=2) + (
        "create_atoms 1 box\nset region half type 2\n"
        "pair_style hybrid sw lj/cut 4.0\n"
        "pair_coeff * * lj/cut 0.0 2.0\n"
        f"pair_coeff * * sw {pot} Si NULL\n"
        "pair_coeff 1 2 lj/cut 0.0 2.0\npair_coeff 2 2 lj/cut 0.0 2.0\n"
        "run 0\n"))
    alone = port_script(tmp_path, head.format(nt=1) + (
        "create_atoms 1 region keep\npair_style sw\n"
        f"pair_coeff * * {pot} Si\nrun 0\n"))
    assert hyb.sim.natoms > alone.sim.natoms > 0
    assert hyb.sim.last_thermo["epair"] == pytest.approx(
        alone.sim.last_thermo["epair"], rel=1e-12)


def test_ters_bij_zeta_to_zero(tmp_path):
    """Si atoms 1 and 2 2.4 A apart; atom 3 sits 1e-8 A inside atom 1's
    R + D = 3.2 A, so its fc is ~1e-15 and the 1-2 bond's zeta ~1e-15.
    LAMMPS's ters_bij takes its 1.0 branch there (beta zeta < c4), whose
    derivative is 0: the 1-2 pair feels the bare fc (f_R + f_A) force.
    The port computes that; tpumd's bond order evaluates every branch at
    max(bz, 1e-30), whose bz^-n overflows, and its forces are NaN
    (ROADMAP C25)."""
    pot = bt.write_potential(tmp_path, "Si.tersoff")
    data = os.path.join(tmp_path, "data.pair")
    with open(data, "w") as fh:
        fh.write("three Si atoms\n\n3 atoms\n1 atom types\n\n"
                 "0.0 20.0 xlo xhi\n0.0 20.0 ylo yhi\n0.0 20.0 zlo zhi\n\n"
                 "Masses\n\n1 28.06\n\nAtoms # atomic\n\n"
                 "1 1 5.0 5.0 5.0\n2 1 7.4 5.0 5.0\n"
                 f"3 1 5.0 {5.0 + 3.2 - 1e-8!r} 5.0\n")
    deck = f"""units metal
atom_style atomic
read_data {data}
pair_style tersoff
pair_coeff * * {pot} Si
neighbor 1.0 bin
run 0
"""
    ts = port_script(tmp_path, deck)
    f = ts.sim.state.f.numpy()[np.argsort(ts.sim.state.tag.numpy())]
    A, lam1, B, lam2 = 3264.7, 3.2394, 95.373, 1.3258
    r = 2.4     # fc = 1 below R - D = 2.8
    fr = -(-lam1 * A * np.exp(-lam1 * r) + lam2 * B * np.exp(-lam2 * r))
    assert np.all(np.isfinite(f))
    assert f[1, 0] == pytest.approx(fr, rel=1e-6)
    assert ts.sim.last_thermo["epair"] == pytest.approx(
        A * np.exp(-lam1 * r) - B * np.exp(-lam2 * r), rel=1e-6)
    with pytest.raises(RuntimeError, match="Non-finite"):
        JScript().run_string(deck)


@pytest.mark.parametrize("style", ["sw", "tersoff"])
def test_32k_step0_gate_values(style, tmp_path):
    """The 32k decks' f64 step-0 gates: the perfect lattice's pe per atom
    and virial pressure at 3x3x3 cells, from tpumd (bench_targets
    MB32K_STEP0), which a perfect periodic lattice gives at any size."""
    pot = bt.write_potential(tmp_path, bt.MB32K_POTENTIAL[style])
    deck = bt.IN_MB32K.format(style=style, potential=pot, nx=3, ny=3,
                              nz=3).replace("run ", "# run ")
    js = JScript()
    js.run_string(deck + "run 0\n")
    got = bt.mb32k_step0(js.sim.last_thermo, js.sim.natoms,
                         float(np.prod(np.asarray(js.sim.state.box.lengths))))
    assert not bt.mb32k_step0_failures(got, bt.MB32K_STEP0[style], 1e-13)


@pytest.mark.parametrize("style", ["sw", "tersoff"])
def test_32k_f32_cpu_gaps(style, tmp_path):
    """The f32 gaps that the card's 32k f32 gates scale (bench_targets
    MB32K_F32_CPU_GAP, per column the larger of this deck's and the 32k
    deck's, probes/mb32k_cpu_gaps.py): the 3x3x3 deck in f32 from the f64
    run's velocities, its step-100 row and its forces on the f64 run's
    step-100 positions against f64, each under its basis."""
    pot = bt.write_potential(tmp_path, bt.MB32K_POTENTIAL[style])
    deck = bt.IN_MB32K.format(style=style, potential=pot, nx=3, ny=3,
                              nz=3)
    gaps = bt.mb32k_f32_gaps(
        lambda dt: port_script(tmp_path, deck, dtype=dt), steps=100)
    cap = bt.MB32K_F32_CPU_GAP[style]
    for k, g in gaps.items():
        assert g <= cap[k], (k, g, cap[k])


def test_sw_f32_leg_rounding_to_the_cutoff(tmp_path):
    """In f32 a leg can pass r2 < cut^2 (cut^2 rounded from the f64
    product) while sqrt(r2) rounds to cut itself; sw's exp(sigma / (r -
    cut)) is then exp(+inf) and its gradient NaN.  The port counts a leg
    inside only where sqrt(r2) < cut as well (ROADMAP C27): two atoms that
    far apart feel nothing, and every number is finite."""
    from tpumd_torch.core.state import Box
    from tpumd_torch.models.registry import create_pair_style
    pot = bt.write_potential(tmp_path, "Si.sw")
    sw = create_pair_style("sw", 1, [])
    sw.coeff(1, 1, 1, 1, pot, "Si")
    sw.init()
    f32 = torch.float32
    cut = sw.max_cutoff
    d = torch.tensor([1.736513376235962, 0.788679838180542,
                      -3.253352642059326], dtype=f32)
    r2 = torch.sum(d * d)
    # the case: inside cut^2, yet of length cut in f32
    assert r2 < cut * cut and float(torch.sqrt(r2)) == float(
        torch.tensor(cut, dtype=f32))
    x = torch.stack([torch.full((3,), 10.0, dtype=f32),
                     torch.full((3,), 10.0, dtype=f32) + d])
    box = Box(lo=torch.zeros(3, dtype=f32),
              hi=torch.full((3,), 30.0, dtype=f32))
    idx = torch.tensor([[1], [0]], dtype=torch.int32)
    f, e, _, v = sw.compute(x, torch.ones(2, dtype=torch.int32), box, idx,
                            torch.zeros_like(idx), None, None, True, True)
    assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(v).all())
    assert float(e) == 0.0 and float(f.abs().max()) == 0.0
