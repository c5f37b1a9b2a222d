"""fix nvt / npt / nph of the port against tpumd and the reference binary.

Each keyword case runs the same 500-atom lj deck (fcc 5^3, the rebuild
check every step) through tpumd (float64 on the CPU, its matrix engine)
and through tpumd_torch on the CPU in float64 on the cell grid; every
thermo row (temp, epair, etotal, press, vol and the three lengths) holds
to 1e-10 relative over 30 steps.  The cases cover iso, aniso, x+y, mtk
yes/no, pchain 0/3, tchain 1/3, drag, nph and nvt.  tests/golden/tri_npt's
two decks (fix npt tri, and aniso on a tilted box) run on the port's
matrix engine against the reference binary's numbers that
tests/test_triclinic.py:66 and :90 hold tpumd to.  The parser takes
LAMMPS's default npt line and raises on keywords neither package takes.
"""

import os

import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.md.fix_nh import FixNH
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")

DECK = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 5 0 5 0 5
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.44 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
neigh_modify every 1 delay 0 check yes
fix 1 all {fix}
thermo 10
thermo_style custom step temp epair etotal press vol lx ly lz
"""
COLUMNS = ("temp", "epair", "etotal", "press", "vol", "lx", "ly", "lz")

CASES = {
    # LAMMPS's default form: tchain 3, pchain 3, mtk yes
    "iso": "npt temp 1.5 1.5 0.5 iso 1.0 1.0 5.0",
    "aniso": "npt temp 1.5 1.5 0.5 aniso 1.0 1.0 5.0",
    "x_y": "npt temp 1.5 1.5 0.5 x 1.0 1.0 5.0 y 2.0 2.0 5.0",
    "iso_mtk_no": "npt temp 1.5 1.5 0.5 iso 1.0 1.0 5.0 mtk no",
    "iso_pchain0": "npt temp 1.5 1.5 0.5 iso 1.0 1.0 5.0 pchain 0",
    "iso_tchain1": "npt temp 1.5 1.3 0.5 iso 1.0 2.0 5.0 tchain 1",
    "aniso_drag": "npt temp 1.5 1.5 0.5 aniso 1.0 1.0 5.0 drag 0.2",
    "nph": "nph iso 1.0 1.0 5.0",
    "nph_z": "nph z 0.5 0.5 5.0 pchain 1 mtk no",
    "nvt": "nvt temp 1.5 1.5 0.5",
    "nvt_tchain1_drag": "nvt temp 1.5 1.0 0.5 tchain 1 drag 0.5",
}


def rows(script):
    """The thermo rows a run printed, as dicts of floats."""
    return [dict(zip(script.sim.thermo_style, map(float, ln.split())))
            for ln in script.sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fix_nh_against_tpumd(case):
    deck = DECK.format(fix=CASES[case]) + "run 30\n"
    j = JScript()
    j.run_string(deck)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    assert t.sim._ctx.is_cellgrid
    jr, tr = rows(j), rows(t)
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [
        0, 10, 20, 30]
    for a, b in zip(tr, jr):
        for k in COLUMNS:
            assert a[k] == pytest.approx(b[k], rel=1e-10, abs=1e-12), (
                case, a["step"], k)
    if "nph" in case or "nvt" in case:
        return
    # the barostat moved the box on every coupled axis
    moved = [tr[-1][k] != tr[0][k] for k in ("lx", "ly", "lz")]
    assert moved == [True, True, True] if case != "x_y" else [True, True,
                                                              False]


def test_nph_targets_the_setup_temperature():
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(DECK.format(fix="nph iso 1.0 1.0 5.0") + "run 0\n")
    fx = t.sim.fixes[0]
    fst = t.sim._carry[2][0]
    assert not fx.tstat and fx.mtk and fx.mpchain == 3
    assert float(fst.t_target) == float(fst.t0) == pytest.approx(1.44,
                                                                 rel=1e-12)


@pytest.mark.parametrize("deck,want", [
    ("in.test", {"temp": (1.2507388, 1e-6), "epair": (-0.66905984, 1e-6),
                 "etotal": (1.1920395, 1e-6), "press": (0.0073729042, 1e-4),
                 "vol": (613.39659, 1e-7), "xy": (2.5488944, 1e-7),
                 "xz": (1.2743966, 1e-7), "yz": (1.6993669, 1e-7),
                 "lx": (8.496483, 1e-7)}),
    ("in.aniso", {"temp": (1.2507388, 1e-6), "etotal": (1.1920409, 1e-6),
                  "vol": (613.39674, 1e-7), "xy": (2.5490005, 1e-7)})])
def test_tri_npt_golden(deck, want):
    """tri_npt (the six-component barostat: the tilt kicks, the tilt
    velocity couplings and the time-symmetric tilt updates) and in.aniso
    (unbarostatted tilts scaled with the cell) on the matrix engine."""
    s = TScript(device="cpu", dtype=torch.float64)
    s.data_dir = os.path.join(GOLDEN, "tri_lj")
    with open(os.path.join(GOLDEN, "tri_npt", deck)) as fh:
        s.run_string(fh.read())
    assert not s.sim._ctx.is_cellgrid and s.sim.state.box.istriclinic
    v = s.sim.last_thermo
    assert v["step"] == 20
    for k, (ref, rel) in want.items():
        assert v[k] == pytest.approx(ref, rel=rel), k


def test_parse_defaults_and_keywords():
    fx = FixNH.parse("npt", "temp 300 300 100 iso 1 1 1000".split())
    assert (fx.mtchain, fx.mpchain, fx.mtk, fx.iso) == (3, 3, True, True)
    assert fx.p_flags == (True,) * 3 + (False,) * 3
    tri = FixNH.parse("npt", "temp 1 1 1 tri 0.5 0.6 5 pchain 2".split())
    assert tri.p_flags == (True,) * 6 and tri.tri and tri.mpchain == 2
    assert tri.p_start == (0.5,) * 3 + (0.0,) * 3
    # tpumd's silent keywords at LAMMPS's defaults
    same = FixNH.parse("npt", "temp 1 1 1 iso 0 0 5 tloop 1 ploop 1 "
                              "nreset 0 scalexy yes scaleyz yes scalexz yes "
                              "fixedpoint 1 2 3".split())
    assert same.fixedpoint == (1.0, 2.0, 3.0) and same.mtk
    for args, word in (("tloop 2", "tloop"), ("ploop 3", "ploop"),
                       ("nreset 10", "nreset"), ("scalexy no", "scalexy"),
                       ("couple xyz", "couple"), ("dilate all", "dilate"),
                       ("update dipole", "update"), ("ptemp 1.0", "ptemp")):
        with pytest.raises(NotImplementedError, match=word):
            FixNH.parse("npt", f"temp 1 1 1 iso 0 0 5 {args}".split())
    with pytest.raises(ValueError, match="temp"):
        FixNH.parse("nph", "temp 1 1 1 iso 0 0 5".split())
    with pytest.raises(ValueError, match="barostat"):
        FixNH.parse("npt", "temp 1 1 1".split())


def test_fixedpoint_off_centre_raises():
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(DECK.format(fix="npt temp 1.5 1.5 0.5 iso 1 1 5 "
                                 "fixedpoint 0 0 0"))
    with pytest.raises(NotImplementedError, match="fixedpoint"):
        t.run_string("run 0")


def test_rebuild_check_box_term_under_iso():
    """The cell grid's rebuild check with every atom moved 0.3 and the box
    dilated about its centre on all three axes by d at each face: the
    half-skin trigger shrinks by how far the corners moved (2 sqrt(3) d),
    so it fires once 0.3 > (skin - 2 sqrt(3) d) / 2, and not before."""
    from tpumd_torch.core.state import Box
    from tpumd_torch.ops.cellgrid import displacement_exceeded
    dt = torch.float64
    lo0 = torch.zeros(3, dtype=dt)
    hi0 = torch.full((3,), 20.0, dtype=dt)
    xhold = torch.rand((64, 3), generator=torch.Generator().manual_seed(3),
                       dtype=dt) * 20.0
    x = xhold + torch.tensor([0.3, 0.0, 0.0], dtype=dt)
    valid = torch.ones(64, dtype=torch.bool)
    skin = 2.0
    assert not bool(displacement_exceeded(x, xhold, valid, Box(lo=lo0,
                                                               hi=hi0),
                                          skin, lo0, hi0))
    # fires past d = (skin - 0.6) / (2 sqrt 3) = 0.4041
    for d, fires in ((0.40, False), (0.41, True)):
        box = Box(lo=lo0 - d, hi=hi0 + d)
        assert bool(displacement_exceeded(x, xhold, valid, box, skin, lo0,
                                          hi0)) is fires, d
