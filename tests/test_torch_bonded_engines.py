"""The bonded layer on both engines (CPU, float64):

- a CHARMM deck with bonded styles (tests/golden/water_shake: harmonic
  bonds, CHARMM angles, SHAKE, lj/charmm/coul/long, PPPM) gives the same
  step-0 forces and energies on the cell grid (B5's plain version) and on
  the matrix engine (P1's plain version), to 1e-10;
- the engine rules: the pure-FENE chain deck keeps B2 on the grid,
  per-tuple styles beside single-type lj/cut take the grid under "auto"
  (B1-special) and equal the forced matrix engine, beside two-type lj/cut
  the matrix engine, and raise under a forced cellgrid there, naming the
  matrix engine;
- branched FENE: bonded2/in.feneexp's styles (and plain fene) on a
  generated chain with cross-links, atoms with 3 bond partners, through
  tpumd and the port (per tuple: fene/expand on the grid, fene on the
  matrix engine);
- the hyb32k cell (bench_targets.hyb_cell): the port against tpumd at
  steps 0 and 100, both against the rows stored in bench_targets, and
  the cell replicated 2x2x2 with per-atom energies equal to the cell's;
- the hyb32k cell's f32 force gaps, the base of the f32 gates: step 0's
  (its worst atom on a harmonic improper near 180 deg) and each term's
  alone on the f64 run's step-100 positions;
- bond_style quartic breaks the same bonds at the same steps as tpumd.
``-m slow`` adds tpumd's 1,000-step drift of the cell, the gate's base,
and the force gaps of the 32k deck itself."""

import contextlib
import os
import shutil

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
KEYS = ("temp", "epair", "ebond", "eangle", "edihed", "eimp", "etotal",
        "press")


def tpumd_run(text, where):
    script = JScript(data_dir=str(where))
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        script.run_string(text)
    return script


def port_run(text, where, mode=None, dtype=torch.float64):
    """The port's script after the deck text; with mode, neighbor_mode is
    set before the deck's first run line."""
    script = TScript(device="cpu", dtype=dtype)
    script.data_dir = str(where)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        if mode is None:
            script.run_string(text)
        else:
            pre, runs = text.split("\nrun", 1)
            script.run_string(pre)
            script.sim.neighbor_mode = mode
            script.run_string("run" + runs)
    return script


def tag_forces(sim, name="f"):
    """The forces (or the field name) in tag order (a grid's empty slots,
    tag 0, dropped)."""
    s = sim._carry[0]
    live = s.tag > 0
    return getattr(s, name)[live][torch.argsort(s.tag[live])].numpy()


def test_charmm_bonded_grid_equals_matrix(tmp_path):
    d = os.path.join(GOLD, "water_shake")
    shutil.copy(os.path.join(d, "data.water"), tmp_path)
    with open(os.path.join(d, "in.test")) as fh:
        deck = fh.read().rsplit("\nrun", 1)[0] + "\nrun 0\n"
    deck = deck.replace("dump ", "#dump ").replace("dump_modify",
                                                   "#dump_modify")
    grid = port_run(deck, tmp_path, "auto").sim
    matrix = port_run(deck, tmp_path, "matrix").sim
    assert grid._ctx.is_cellgrid and not matrix._ctx.is_cellgrid
    assert [st.name for st, _ in matrix._ctx.bonded] == ["harmonic",
                                                        "charmm"]
    fg, fm = tag_forces(grid), tag_forces(matrix)
    np.testing.assert_allclose(fm, fg, rtol=0,
                               atol=1e-10 * np.abs(fg).max())
    for k in ("evdwl", "ecoul", "elong", "ebond", "eangle", "etotal",
              "press"):
        assert matrix.last_thermo[k] == pytest.approx(
            grid.last_thermo[k], rel=1e-10, abs=1e-10), k


def chain_deck(tmp_path, natoms=500, chain_len=25):
    path = tmp_path / "data.chain"
    bt.chain_data(str(path), natoms=natoms, chain_len=chain_len)
    return path


def test_engine_rules(tmp_path):
    """The pure-FENE chain stays on B2; per-tuple styles beside
    single-type lj/cut (the hyb cell 2x2x2) take the grid under "auto",
    where B1's special-weighted variant weighs the 1-4 pairs, and the
    forced matrix engine gives the same step-0 row; beside two-type lj/cut
    they go to the matrix engine, and raise on a forced cellgrid."""
    path = chain_deck(tmp_path)
    chain = port_run(bt.IN_CHAIN.format(data=path) + "run 0\n", tmp_path)
    assert chain.sim._ctx.is_cellgrid
    assert chain.sim._ctx.kernel_bond is not None
    assert chain.sim._ctx.bonded == ()
    hyb = hyb_deck(tmp_path, 2) + "run 0\n"
    grid = port_run(hyb, tmp_path).sim
    matrix = port_run(hyb, tmp_path, "matrix").sim
    assert grid._ctx.is_cellgrid and not matrix._ctx.is_cellgrid
    assert grid.state.special_tags is not None
    assert len(grid._ctx.bonded) == 8
    for k in KEYS:
        assert grid.last_thermo[k] == pytest.approx(
            matrix.last_thermo[k], rel=1e-10, abs=1e-10), k
    d = os.path.join(GOLD, "bonded_misc")
    shutil.copy(os.path.join(d, "data.water"), tmp_path)
    with open(os.path.join(d, "in.test")) as fh:
        deck = fh.read()
    assert not port_run(deck, tmp_path).sim._ctx.is_cellgrid
    with pytest.raises(NotImplementedError,
                       match="bond_style morse.*matrix engine"):
        port_run(deck, tmp_path, "cellgrid")


def branched(path, tmp_path, links=12, seed=7):
    """The chain data file with cross-links between beads one lattice step
    apart in different places of the chains: 2 x links atoms with 3 bond
    partners."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = lines.index("Atoms")
    n = int(lines[2].split()[0])
    atoms = np.array([[float(t) for t in ln.split()[:6]]
                      for ln in lines[i + 2:i + 2 + n]])
    x = atoms[np.argsort(atoms[:, 0]), 3:6]
    bounds = np.array([[float(t) for t in ln.split()[:2]] for ln in lines
                       if ln.endswith(("xhi", "yhi", "zhi"))])
    box = bounds[:, 1] - bounds[:, 0]
    b = lines.index("Bonds")
    nb = int(next(ln for ln in lines if ln.endswith(" bonds")).split()[0])
    bonds = [tuple(int(t) for t in ln.split()[2:4])
             for ln in lines[b + 2:b + 2 + nb]]
    degree = np.zeros(n + 1, int)
    for a, c in bonds:
        degree[a] += 1
        degree[c] += 1
    rng = np.random.default_rng(seed)
    new = []
    for a in rng.permutation(np.arange(1, n + 1)):
        if len(new) == links:
            break
        if degree[a] != 2:
            continue
        d = x - x[a - 1]
        d -= box * np.round(d / box)
        r = np.sqrt((d * d).sum(1))
        for c in np.argsort(r)[1:8] + 1:
            if degree[c] == 2 and r[c - 1] < 1.2 and abs(c - a) > 3:
                new.append((a, c))
                degree[a] += 1
                degree[c] += 1
                break
    assert len(new) == links
    rows = [f"{nb + k + 1} 1 {a} {c}" for k, (a, c) in enumerate(new)]
    out = lines[:b + 2 + nb] + rows + lines[b + 2 + nb:]
    out = [f"{nb + links} bonds" if ln.endswith(" bonds") else ln
           for ln in out]
    dst = tmp_path / "data.branched"
    dst.write_text("\n".join(out) + "\n")
    return dst, int((degree == 3).sum())


FENE_DECK = """units lj
atom_style bond
special_bonds fene
read_data {data}
bond_style {style}
bond_coeff 1 {coeffs}
pair_style lj/cut 1.12
pair_coeff 1 1 1.0 1.0 1.12
neighbor 0.4 bin
neigh_modify every 1 delay 1
velocity all create 1.0 4928 loop geom
fix 1 all nve
thermo 10
run 20
"""


@pytest.mark.parametrize("style,coeffs", [
    ("fene/expand", "30.0 1.5 1.0 1.0 0.1"),   # bonded2/in.feneexp's
    ("fene", "30.0 1.5 1.0 1.0")])
def test_branched_fene_against_tpumd(style, coeffs, tmp_path):
    data, three = branched(chain_deck(tmp_path), tmp_path)
    assert three == 24
    deck = FENE_DECK.format(data=data, style=style, coeffs=coeffs)
    port = port_run(deck, tmp_path).sim
    ref = tpumd_run(deck, tmp_path).sim
    # per tuple on either engine: fene/expand beside lj/cut on the grid
    # (B1-special weighs the 1-2 pairs 0), fene with 3 partners on the
    # matrix engine (B2 holds 2)
    assert port._ctx.kernel_bond is None
    assert port._ctx.is_cellgrid == (style == "fene/expand")
    for k in ("temp", "epair", "ebond", "etotal", "press"):
        assert port.last_thermo[k] == pytest.approx(
            float(ref.last_thermo[k]), rel=1e-9), k


def hyb_deck(tmp_path, n=1):
    data = tmp_path / "data.hyb"
    if not data.exists():
        bt.hyb_cell(str(data))
    return bt.IN_HYB32K.format(data=data, n=n, thermo=100)


def test_hyb_cell_against_tpumd(tmp_path):
    """The port and tpumd at steps 0 and 100 on the hyb32k cell, and both
    against the rows bench_targets stores."""
    deck = hyb_deck(tmp_path)
    rows = {}
    for name, run in (("port", port_run), ("tpumd", tpumd_run)):
        script = run(deck + "run 0\n", tmp_path)
        r0 = dict(script.sim.last_thermo)
        script.run_string("run 100")
        rows[name] = (r0, dict(script.sim.last_thermo))
    for name, (r0, r100) in rows.items():
        for want, got, rel in ((bt.HYB_CELL_STEP0, r0, 1e-12),
                               (bt.HYB_CELL_STEP100, r100, 1e-10)):
            for k in KEYS:
                assert float(got[k]) == pytest.approx(
                    want[k], rel=rel, abs=1e-10), (name, k)


def test_hyb_cell_replicated_per_atom(tmp_path):
    """replicate 2 2 2: every atom's pe/atom equals its cell atom's."""
    pea, pe = {}, {}
    for n in (1, 2):
        script = port_run(hyb_deck(tmp_path, n)
                          + "compute pea all pe/atom\nrun 0\n", tmp_path)
        pea[n] = script.sim.computes["pea"](script.sim).numpy()
        pe[n] = script.sim.last_thermo["pe"]
    cell = pea[1]
    assert pea[2].shape == (8 * 256,)
    assert cell.sum() == pytest.approx(pe[1], rel=1e-12)
    assert pea[2].sum() == pytest.approx(pe[2], rel=1e-12)
    np.testing.assert_allclose(pea[2].reshape(8, 256),
                               np.broadcast_to(cell, (8, 256)), rtol=1e-10,
                               atol=1e-10 * np.abs(cell).max())


def improper_chi(x, length, rows):
    """Each improper's chi in degrees as improper_harmonic.cpp computes
    it, from positions x (tag order) in a cube of edge length."""
    a = np.asarray(rows)[:, 1:] - 1

    def image(d):
        return d - length * np.round(d / length)

    vb1 = image(x[a[:, 0]] - x[a[:, 1]])
    vb2 = image(x[a[:, 2]] - x[a[:, 1]])
    vb3 = image(x[a[:, 3]] - x[a[:, 2]])
    r1, r2, r3 = (np.sqrt((v * v).sum(-1)) for v in (vb1, vb2, vb3))
    c0 = (vb1 * vb3).sum(-1) / (r1 * r3)
    c1 = (vb1 * vb2).sum(-1) / (r1 * r2)
    c2 = -(vb3 * vb2).sum(-1) / (r3 * r2)
    s12 = 1.0 / np.sqrt(np.maximum(1 - c1 * c1, 1e-3)
                        * np.maximum(1 - c2 * c2, 1e-3))
    return np.degrees(np.arccos(np.clip((c1 * c2 + c0) * s12, -1, 1)))


@pytest.mark.parametrize("n,gap,terms", [
    (1, bt.HYB_F32_FORCE_GAP_CELL, bt.HYB_F32_TERM_GAP_CELL),
    pytest.param(bt.HYB32K_REPLICAS, bt.HYB_F32_FORCE_GAP_32K,
                 bt.HYB_F32_TERM_GAP_32K, marks=pytest.mark.slow)],
    ids=["cell", "32k"])
def test_hyb_f32_force_gaps(n, gap, terms, tmp_path):
    """The f32 force gaps that the hyb32k gates are 3x of, measured again.
    Step 0: the worst atom sits on a harmonic improper at chi > 179.5 deg,
    and every harmonic improper lies within 4 deg of 180.  Each term alone
    (hyb_term_forces) in f32 on the f64 run's step-100 positions.  On
    the matrix engine, where the gated hyb32k run stays (the cell would
    take the grid under "auto")."""
    deck = hyb_deck(tmp_path, n)
    f64 = port_run(deck + "run 0\n", tmp_path, "matrix")
    f32 = port_run(deck + "run 0\n", tmp_path, "matrix", dtype=torch.float32)
    a, b = tag_forces(f64.sim), tag_forces(f32.sim).astype(np.float64)
    err = np.abs(b - a).max(-1)
    assert err.max() / np.abs(a).max() == pytest.approx(gap, rel=1e-2)
    rows = np.asarray(f64.sim.topology["improper"])
    chi = improper_chi(tag_forces(f64.sim, "x"),
                       float(f64.sim.state.box.volume) ** (1 / 3), rows)
    harmonic = rows[:, 0] == 1
    assert chi[harmonic].min() > 176.0
    at = np.nonzero(harmonic & (rows[:, 1:] == err.argmax() + 1).any(-1))[0]
    assert at.size == 1 and chi[at[0]] > 179.5
    f64.run_string("run 100")
    probe = port_run(deck, tmp_path, dtype=torch.float32)
    probe.sim.neighbor_mode = "matrix"
    x100 = torch.as_tensor(tag_forces(f64.sim, "x"))
    s = probe.sim.state
    probe.sim.state = s.replace(x=x100[s.tag - 1].to(torch.float32))
    probe.run_string("run 0")
    got = bt.hyb_term_gaps(bt.hyb_term_forces(probe.sim),
                           bt.hyb_term_forces(f64.sim))
    assert sorted(got) == sorted(terms)
    for k, v in terms.items():
        assert got[k] == pytest.approx(v, rel=1e-2), k


def test_quartic_breaks_the_same_bonds_as_tpumd(tmp_path):
    d = os.path.join(GOLD, "bond_quartic")
    shutil.copy(os.path.join(d, "data.bq"), tmp_path)
    with open(os.path.join(d, "in.test")) as fh:
        deck = fh.read().split("\nrun", 1)[0]
    deck = deck.replace("dump ", "#dump ").replace("dump_modify",
                                                   "#dump_modify")
    port = port_run(deck + "\nrun 0\n", tmp_path)
    ref = tpumd_run(deck + "\nrun 0\n", tmp_path)
    bonds = np.asarray(port.sim.topology["bond"])
    broke_at = {}
    for step in range(1, 61):
        port.run_string("run 1")
        ref.run_string("run 1")
        alive = port.sim.bonded["bond"].alive.numpy()
        # tpumd's alive flags ride its per-atom incidence (rows; the
        # partner's tag names the bond)
        s = ref.sim.state
        style = next(b for b in ref.sim.bonded if b.kind == "bond")
        idx, _, role, mask = (np.asarray(a)
                              for a in style.device_incidence())
        jalive = np.asarray(s.extras["bq_alive"]) > 0.5
        tags = np.asarray(s.tag)
        dead = {tuple(sorted((int(tags[idx[i, p, 0]]),
                              int(tags[idx[i, p, 1]]))))
                for i, p in zip(*np.nonzero(mask & ~jalive))}
        ours = {tuple(sorted(map(int, bonds[b, 1:])))
                for b in np.nonzero(~alive)[0]}
        assert ours == dead, step
        for bond in ours:
            broke_at.setdefault(bond, step)
        assert port.sim.last_thermo["ebond"] == pytest.approx(
            float(ref.sim.last_thermo["ebond"]), rel=1e-9)
    assert len(broke_at) == 2


@pytest.mark.slow
def test_hyb_cell_drift_from_tpumd(tmp_path):
    """tpumd's energy drift of the cell over 1,000 f64 steps (rows every
    100): HYB_CELL_DRIFT_F64, of which HYB_DRIFT_TOL is 3x."""
    script = tpumd_run(hyb_deck(tmp_path) + "run 0\n", tmp_path)
    e = [script.sim.last_thermo["etotal"]]
    for _ in range(10):
        script.run_string("run 100")
        e.append(script.sim.last_thermo["etotal"])
    e = np.array(e)
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    assert drift == pytest.approx(bt.HYB_CELL_DRIFT_F64, rel=1e-6)
    assert bt.HYB_DRIFT_TOL == 3 * bt.HYB_CELL_DRIFT_F64
