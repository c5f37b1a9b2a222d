"""The matrix neighbor engine end to end: the port against tpumd and
against the reference binary's logs, on the CPU in f64.

Decks run through tpumd and tpumd_torch with ``neighbor_mode = "matrix"``
(tpumd's own choice on the CPU), and the printed thermo rows (the rebuild
count included) are equal (marked slow: tpumd compiles each deck's step,
6-15 s a deck):

* in.lj on 6^3 cells, 40 steps (two scheduled rebuilds);
* lj/cut with two types and arithmetic mixing (the cell grid's kernels
  take one type, so "auto" picks the matrix engine for it);
* lj/cut on ``boundary p p f``, a slab with free surfaces;
* the 480-sphere chute pack (``bench_targets.chute_data(path, 10, 6, 8)``),
  40 steps with a rebuild every 5 (the deck's own check rebuilds once in
  40 steps), with the shear history keyed by (tag_i, tag_j) equal to
  1e-10 of its largest entry.

The golden decks hold the port to the reference binary: ``small_box``
(a 3.36 sigma box, every pair through several images) on every row of
``log.ref`` at rel 1e-7 (tests/test_small_box.py:44-48); ``tri_lj`` (a
triclinic box) on every row of ``thermo.csv`` at
tests/test_triclinic.py:23-28's tolerances; ``lj_tail`` on both engines,
every printed value equal to ``log.test`` to its 8 digits.
"""

import os

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import IN_CHUTE, IN_LJ, chute_data
from tpumd_torch.ops import gather as p1
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

LJ2 = """
units           lj
atom_style      atomic
boundary        {boundary}
lattice         fcc 0.8442
region          box block 0 5 0 5 {zlo} {zhi}
create_box      2 box
region          lower block 0 5 0 5 0 2.4
region          upper block 0 5 0 5 2.4 4.9
create_atoms    1 region lower
create_atoms    {upper} region upper
mass            1 1.0
mass            2 2.0
velocity        all create 1.2 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
pair_coeff      2 2 0.8 1.1 2.2
pair_modify     mix arithmetic
neighbor        0.3 bin
neigh_modify    delay 0 every 1 check yes
fix             1 all nve
thermo          15
"""
# thermo 15 keeps tpumd on its segmented loop for a 40-step run: its
# streamed run (nsteps a multiple of 2+ thermo intervals) redoes the whole
# run after a list overflow, the port (as tpumd's segmented loop) only the
# segment, which moves the later rebuilds
DECKS = {
    "lj_6cube": IN_LJ.format(n=6).replace("thermo          50",
                                          "thermo          15"),
    "lj_two_types": LJ2.format(boundary="p p p", zlo=0, zhi=5, upper=2),
    "lj_ppf": LJ2.format(boundary="p p f", zlo=-1, zhi=6, upper=1),
}


def _thermo_rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


def _run(script, deck, nsteps, mode="matrix"):
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = mode
    script.run_string(f"run {nsteps}")
    return sim


@pytest.mark.slow
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_matrix_decks_match_tpumd(deck):
    text = DECKS[deck]
    jsim = _run(JScript(), text, 40)
    n0 = p1.counts.plain_calls
    tsim = _run(TScript(device="cpu", dtype=torch.float64), text, 40)
    assert p1.counts.plain_calls - n0 > 2 * 41
    assert not tsim._ctx.is_cellgrid
    rows = _thermo_rows(tsim)
    assert rows == _thermo_rows(jsim)
    assert int(tsim._carry[1].nbuilds) == int(jsim._carry[1].nbuilds) > 2
    for k in ("temp", "epair", "etotal", "press"):
        assert tsim.last_thermo[k] == pytest.approx(jsim.last_thermo[k],
                                                    rel=1e-10), k
    if deck == "lj_ppf":
        assert tsim.state.box.periodic == (True, True, False)
    if deck == "lj_two_types":
        # "auto" sends the two-type deck to the matrix engine
        auto = TScript(device="cpu", dtype=torch.float64)
        auto.run_string(text + "run 0\n")
        assert auto.sim._mode == "matrix"
        assert auto.sim.last_thermo["epair"] == pytest.approx(
            float(rows[1].split()[2]), rel=1e-7)


def _history(sim):
    """{(tag_i, tag_j): shear} of the live history slots."""
    s, neigh = sim._carry[0], sim._carry[1]
    tag = np.asarray(s.tag)
    idx = np.asarray(neigh.idx)
    sh = np.asarray(neigh.shear)
    live = sh.any(-1)
    return {(int(tag[i]), int(tag[idx[i, k]])): sh[i, k]
            for i, k in zip(*np.nonzero(live))}


@pytest.mark.slow
def test_matrix_chute_matches_tpumd(tmp_path):
    chute_data(tmp_path / "data.chute", 10, 6, 8)
    deck = IN_CHUTE.format(data=tmp_path / "data.chute").replace(
        "thermo          100", "thermo          10").replace(
        "neigh_modify    every 1 delay 0",
        "neigh_modify    every 5 delay 0 check no")
    jsim = _run(JScript(), deck, 40)
    tsim = _run(TScript(device="cpu", dtype=torch.float64), deck, 40)
    assert tsim._neigh_cfg.exclude_bits and not tsim._ctx.is_cellgrid
    assert _thermo_rows(tsim) == _thermo_rows(jsim)
    nbuilds = int(tsim._carry[1].nbuilds)
    assert nbuilds == int(jsim._carry[1].nbuilds) == 9
    for k in ("ke", "c_1", "vol"):
        assert tsim.last_thermo[k] == pytest.approx(jsim.last_thermo[k],
                                                    rel=1e-10), k
    th, jh = _history(tsim), _history(jsim)
    assert th.keys() == jh.keys() and len(th) > 480
    top = max(np.abs(v).max() for v in jh.values())
    worst = max(np.abs(th[k] - jh[k]).max() for k in jh)
    assert worst <= 1e-10 * top


def _grid_history(sim):
    """{(tag_i, tag_j): shear} of the live history slots on the grid."""
    s, neigh = sim._carry[0], sim._carry[1]
    tag = s.tag.numpy()
    jtag = neigh.shear_tags.numpy()
    sh = neigh.shear.numpy()
    return {(int(tag[i]), int(jtag[i, k])): sh[i, k]
            for i, k in zip(*np.nonzero(sh.any(-1)))}


def test_thin_granular_bed_takes_the_matrix_engine(tmp_path):
    """A bed of two mobile layers over the frozen base is 1.9 sigma deep
    under its shrink-wrapped top, narrower than 2 cutneigh (2.2): the cell
    grid refuses it, and "auto" runs it on the matrix engine.  The same
    pack under a fixed 2.87 sigma top (``boundary p p f``) runs on the grid
    under "auto"; the two agree on every row and on the shear history
    keyed by (tag_i, tag_j), across 8 rebuilds."""
    chute_data(tmp_path / "data.thin", 10, 6, 3)
    deck = IN_CHUTE.format(data=tmp_path / "data.thin").replace(
        "thermo          100", "thermo          10").replace(
        "neigh_modify    every 1 delay 0",
        "neigh_modify    every 5 delay 0 check no")
    forced = TScript(device="cpu", dtype=torch.float64)
    forced.run_string(deck)
    forced.sim.neighbor_mode = "cellgrid"
    with pytest.raises(ValueError, match="2\\*cutneigh"):
        forced.run_string("run 0")
    thin = _run(TScript(device="cpu", dtype=torch.float64), deck, 40, "auto")
    assert thin._mode == "matrix"
    assert thin.state.box.lengths_np()[2] < 2.2
    tall = _run(TScript(device="cpu", dtype=torch.float64),
                deck.replace("boundary        p p fs",
                             "boundary        p p f"), 40, "auto")
    assert tall._ctx.is_cellgrid
    assert int(thin._carry[1].nbuilds) == int(tall._carry[1].nbuilds) == 9
    got, ref = _port_rows(thin), _port_rows(tall)
    assert len(got) == len(ref) == 5
    # step, atoms, ke, c_1 at the printed 8 digits (the volume differs)
    np.testing.assert_allclose(np.float64(got)[:, :4],
                               np.float64(ref)[:, :4], rtol=1e-7)
    for k in ("ke", "c_1"):
        assert thin.last_thermo[k] == pytest.approx(tall.last_thermo[k],
                                                    rel=1e-10), k
    th, gh = _history(thin), _grid_history(tall)
    assert th.keys() == gh.keys() and len(th) > 180
    top = max(np.abs(v).max() for v in gh.values())
    assert max(np.abs(th[k] - gh[k]).max() for k in gh) <= 1e-10 * top


def _log_rows(path):
    rows, active = [], False
    for ln in open(path).read().splitlines():
        if ln.strip().startswith("Step"):
            active = True
            continue
        if active:
            p = ln.split()
            if not p or not p[0].lstrip("-").isdigit():
                active = False
                continue
            rows.append(p)
    return rows


def _port_rows(sim):
    return [ln.split() for ln in sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]


def _golden(name, mode="matrix", edit=lambda text: text):
    script = TScript(device="cpu", dtype=torch.float64)
    path = os.path.join(GOLDEN, name, "in.test")
    text = edit(open(path).read())
    pre, run = text.rsplit("\nrun", 1)
    script.data_dir = os.path.dirname(path)
    script.run_string(pre)
    script.sim.verbose = False
    script.sim.neighbor_mode = mode
    script.run_string("run" + run)
    return script.sim


def test_small_box_matches_the_reference_log():
    sim = _golden("small_box")
    assert len(sim._neigh_cfg.image_shifts) == 27
    ref = _log_rows(os.path.join(GOLDEN, "small_box", "log.ref"))
    got = _port_rows(sim)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g[0] == r[0]
        np.testing.assert_allclose(np.float64(g[1:]), np.float64(r[1:]),
                                   rtol=1e-7)


def test_tri_lj_matches_the_reference_log():
    sim = _golden("tri_lj")
    assert sim.state.box.istriclinic and not sim._ctx.is_cellgrid
    ref = np.loadtxt(os.path.join(GOLDEN, "tri_lj", "thermo.csv"))
    got = np.array(_port_rows(sim), np.float64)
    assert got.shape == ref.shape == (5, 7)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    # temp, epair, etotal at the log's 8 digits; press; the volume
    for col, tol in ((1, dict(rtol=1e-7)), (2, dict(rtol=1e-7)),
                     (4, dict(rtol=1e-7)), (5, dict(rtol=1e-6, atol=1e-9)),
                     (6, dict(rtol=1e-12))):
        np.testing.assert_allclose(got[:, col], ref[:, col], **tol)


NPT = ("fix             1 all npt temp 1.2 1.2 0.5 x 1.0 1.0 5.0 "
       "y 1.0 1.0 5.0 z 1.0 1.0 5.0 pchain 0 mtk no")
TRI_MOVING = {
    "npt": (lambda t: t.replace("fix             1 all nve", NPT),
            "barostat on a triclinic box"),
    "shrink": (lambda t: t.replace("read_data", "boundary p p s\nread_data"),
               "boundary p p s on a triclinic box"),
}


@pytest.mark.parametrize("mode", ["auto", "matrix"])
@pytest.mark.parametrize("case", sorted(TRI_MOVING))
def test_triclinic_box_refuses_a_moving_box(case, mode):
    """A barostat or a shrink-wrapped face on the tri_lj box raises at
    set-up: fix nh and the shrink-wrap move the box in orthogonal
    coordinates, which would leave the tilt factors behind."""
    edit, match = TRI_MOVING[case]
    with pytest.raises(NotImplementedError, match=match):
        _golden("tri_lj", mode, edit)


@pytest.mark.parametrize("mode", ["cellgrid", "matrix"])
def test_lj_tail_matches_the_reference_log(mode):
    sim = _golden("lj_tail", mode)
    assert sim._ctx.is_cellgrid == (mode == "cellgrid")
    ref = _log_rows(os.path.join(GOLDEN, "lj_tail", "log.test"))
    got = _port_rows(sim)
    assert len(got) == len(ref) == 3

    def digits(row):
        return [f"{float(v):.8g}" for v in row]
    assert [digits(g) for g in got] == [digits(r) for r in ref]
