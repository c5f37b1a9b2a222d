"""The tag-matched bonded path on the cell grid (``tpumd_torch/ops/
cellgrid_tuples.py``, ``BondedStyle.reduce_from_xs``, fix shake's
``_apply_grid``) against tpumd's (tpumd/ops/cellgrid_tuples.py), on the
CPU in f64:

* the 4-atom bent chain of tests/test_bonded_grid.py (harmonic bond and
  angle, opls dihedral, harmonic improper) replicated 4x4x4 (256 atoms, a
  4^3 grid) and the water_nve golden's 375 atoms (a 2^3 grid, where tpumd
  keeps the minimum image of each matched tag): the per-atom tables equal
  tpumd's, and after the set-up of both packages with ``bonded_grid``,
  every slot's matched members (their distance from the slot at the
  minimum image, types, charges, found flags) and ``compute_bonded_grid``'s
  forces, energies and virial equal tpumd's by tag to 1e-12;
* the same water box cut into the local grids of two z-slabs (both halos
  of a rank hold the other rank's plane, a box length apart): each owned
  slot's members equal the global grid's by tag;
* water_nve and water_shake, 10 steps on one card with ``bonded_grid``:
  the thermo rows equal tpumd's ``bonded_grid`` run to 1e-10, and x and v
  equal the port's run on the tag-order view to 1e-10 (SHAKE's grid path
  against its path by the rows of the members' tags);
* a tuple or a SHAKE cluster whose member the lookup cannot find raises
  at the segment's flag read, naming the tuple's tags or the fix.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.ops import cellgrid_tuples as ct
from tpumd_torch.parallel.launch import tag_order
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# tests/test_bonded_grid.py's 4-atom bent chain
CHAIN_DATA = """4-atom bent chain

4 atoms
3 bonds
2 angles
1 dihedrals
1 impropers
1 atom types
1 bond types
1 angle types
1 dihedral types
1 improper types

0.0 2.8 xlo xhi
0.0 2.8 ylo yhi
0.0 2.8 zlo zhi

Masses

1 1.0

Atoms

1 1 1 0.5 0.5 0.5
2 1 1 1.5 0.5 0.5
3 1 1 2.2 1.2 0.5
4 1 1 2.3 1.6 1.4

Velocities

1 0.12 -0.05 0.02
2 -0.03 0.08 0.04
3 0.01 0.02 -0.07
4 0.05 -0.06 0.01

Bonds

1 1 1 2
2 1 2 3
3 1 3 4

Angles

1 1 1 2 3
2 1 2 3 4

Dihedrals

1 1 1 2 3 4

Impropers

1 1 1 2 3 4
"""

CHAIN_DECK = """units           lj
atom_style      molecular
boundary        p p p
read_data       data.chain4
replicate       4 4 4
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
bond_style      harmonic
bond_coeff      1 60.0 1.05
angle_style     harmonic
angle_coeff     1 30.0 114.0
dihedral_style  opls
dihedral_coeff  1 1.2 -0.4 0.6 0.0
improper_style  harmonic
improper_coeff  1 8.0 15.0
neighbor        0.3 bin
neigh_modify    delay 0 every 5 check no
fix             1 all nve
"""


def water_deck(name):
    """The golden's deck without its dump and run lines."""
    with open(os.path.join(GOLDEN, name, "in.test")) as fh:
        return "\n".join(ln for ln in fh.read().splitlines()
                         if not ln.startswith(("dump", "run"))) + "\n"


def deck_of(name, tmp_path):
    """(deck, data directory) of a case."""
    if name == "chain":
        (tmp_path / "data.chain4").write_text(CHAIN_DATA)
        return CHAIN_DECK, str(tmp_path)
    d = tmp_path / name
    if not d.exists():
        shutil.copytree(os.path.join(GOLDEN, name), d)
    return water_deck(name), str(d)


def port_sim(deck, data_dir, bonded_grid=True, run=None):
    """A port set-up on the grid (and run, where given)."""
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.data_dir = data_dir
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    sim.bonded_grid = bonded_grid
    script.run_string(run or "run 0")
    return script


def tpumd_sim(deck, data_dir, run=None):
    from tpumd.script.parser import LammpsScript as JScript
    script = JScript(data_dir=data_dir)
    script.run_string(deck)
    script._finalize_atoms()
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    sim.bonded_grid = True
    sim._ctx = None
    if run:
        script.run_string(run)
    else:
        sim.setup()
    return script


def by_tag(tag, *arrays):
    """The arrays' rows of the valid slots in tag order (numpy)."""
    tag = np.asarray(tag)
    keep = np.nonzero(tag > 0)[0]
    order = keep[np.argsort(tag[keep])]
    return [np.asarray(a)[order] for a in arrays]


def rel_members(x, mpos, box_lengths):
    """Each matched member's displacement from its slot at the minimum
    image (numpy)."""
    d = np.asarray(mpos) - np.asarray(x)[:, None, :]
    ell = np.asarray(box_lengths)
    return d - np.round(d / ell) * ell


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """{case: (port script, tpumd script)} after each one's set-up."""
    out = {}
    for name in ("chain", "water_nve"):
        deck, data = deck_of(name, tmp_path_factory.mktemp(name))
        out[name] = (port_sim(deck, data), tpumd_sim(deck, data))
    return out


@pytest.mark.parametrize("name", ["chain", "water_nve"])
def test_tuple_tables_equal_tpumd(name, both):
    from tpumd.ops import cellgrid_tuples as jct
    script, jscript = both[name]
    sim, jsim = script.sim, jscript.sim
    assert sim._ctx.bonded_grid and jsim._ctx.bonded_grid
    arities = {k: st.arity for k, st in sim.bonded.items()}
    topo = {k: sim.topology[k] for k in arities}
    ours = ct.build_tuple_tables(sim.natoms, topo, arities)
    theirs = jct.build_tuple_tables(sim.natoms, topo, arities)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    # and as each package's state carries them, by tag
    s, js = sim._carry[0], jsim._carry[0]
    for k in ours:
        a, = by_tag(s.tag.numpy(), s.peratom[k].numpy())
        b, = by_tag(np.asarray(js.tag), np.asarray(js.extras[k]))
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", ["chain", "water_nve"])
def test_matched_members_equal_tpumd(name, both):
    from tpumd.ops import cellgrid_tuples as jct
    script, jscript = both[name]
    s, js = script.sim._carry[0], jscript.sim._carry[0]
    mpos, mtype, mq, found = ct.match_members(s.x, s.tag, s.type, s.q,
                                              s.peratom["_bt_utags"])
    jmpos, jmtype, jmq, jfound = jct.match_members(
        js.x, js.tag, js.type, js.q, js.tag > 0, js.box,
        jscript.sim._ctx.neigh_cfg, js.extras["_bt_utags"])
    ell = s.box.lengths.numpy()
    a = by_tag(s.tag.numpy(), rel_members(s.x, mpos, ell), mtype, found,
               *(() if mq is None else (mq,)))
    b = by_tag(np.asarray(js.tag), rel_members(js.x, jmpos, ell), jmtype,
               jfound, *(() if jmq is None else (jmq,)))
    assert bool(a[2].any()) and np.array_equal(a[2], b[2])
    np.testing.assert_allclose(np.where(a[2][..., None], a[0], 0.0),
                               np.where(b[2][..., None], b[0], 0.0),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.where(a[2], a[1], 0),
                                  np.where(b[2], b[1], 0))
    if len(a) > 3:
        np.testing.assert_allclose(np.where(a[2], a[3], 0.0),
                                   np.where(b[2], b[3], 0.0), atol=1e-15)


@pytest.mark.parametrize("name", ["chain", "water_nve"])
def test_bonded_grid_forces_equal_tpumd(name, both):
    from tpumd.ops import cellgrid_tuples as jct
    script, jscript = both[name]
    sim, jsim = script.sim, jscript.sim
    s, js = sim._carry[0], jsim._carry[0]
    f, e, vir, missing = ct.compute_bonded_grid(
        s, sim._ctx, [st for st, _ in sim._ctx.bonded], True, True)
    jf, je, jvir, jall = jct.compute_bonded_grid(js, jsim._ctx,
                                                 jsim._consts, True, True)
    assert not bool(missing) and bool(jall)
    a, = by_tag(s.tag.numpy(), f.numpy())
    b, = by_tag(np.asarray(js.tag), np.asarray(jf))
    # the water box starts at its bonds' and angles' rest geometry, where
    # the forces are ~1e-5 of one unit and the last bits of r - r0 count:
    # 1e-12 of the larger of max|f| and one unit
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale)
    assert e.keys() == {k for k in je}
    for k in e:
        assert float(e[k]) == pytest.approx(float(je[k]), rel=1e-12,
                                            abs=1e-12), k
    np.testing.assert_allclose(vir.numpy(), np.asarray(jvir), rtol=1e-12,
                               atol=1e-12 * scale)


def test_local_grid_members_equal_the_global_grid(both):
    """water_nve's 2^3 grid as two z-slabs: a rank's local grid holds the
    other rank's plane in both halos, a box length apart; the lookup keeps
    the copy nearest the slot, so each owned slot's members (positions at
    the minimum image, types, charges) equal the global grid's."""
    from tpumd_torch.parallel.decomp import GridLayout, assemble_slots
    sim = both["water_nve"][0].sim
    s, neigh, _ = sim._carry
    cfg = sim._neigh_cfg
    utags = s.peratom["_bt_utags"]
    g = ct.match_members(s.x, s.tag, s.type, s.q, utags)
    ell = s.box.lengths.numpy()
    want = by_tag(s.tag.numpy(), rel_members(s.x, g[0], ell), g[1], g[3],
                  g[2])
    seen = 0
    for rank in range(2):
        lay = GridLayout(cfg, 2, 1, rank)
        assert lay.copies == 2
        sl, vl = assemble_slots(lay, s, neigh.valid)
        own = vl & torch.as_tensor(lay.slot_maps[2])
        loc = ct.match_members(sl.x, sl.tag, sl.type, sl.q,
                               sl.peratom["_bt_utags"], copies=lay.copies)
        # a halo copy sits a box length from the global position; the
        # nearest copy is within the tuple's span of its slot
        d = loc[0] - sl.x[:, None, :]
        span = torch.sqrt(torch.sum(d * d, dim=-1))
        assert float(span[own][loc[3][own]].max()) < 2.0
        tags = sl.tag[own].numpy()
        got = by_tag(tags, rel_members(sl.x[own], loc[0][own], ell),
                     loc[1][own], loc[3][own], loc[2][own])
        rows = np.sort(tags) - 1
        np.testing.assert_array_equal(got[2], want[2][rows])
        np.testing.assert_allclose(got[0], want[0][rows], rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(got[1], want[1][rows])
        np.testing.assert_array_equal(got[3], want[3][rows])
        seen += len(rows)
    assert seen == sim.natoms


@pytest.mark.parametrize("name", ["water_nve", "water_shake"])
def test_one_card_bonded_grid_run(name, tmp_path):
    deck, data = deck_of(name, tmp_path)
    run = "run 10"
    grid = port_sim(deck, data, True, run)
    view = port_sim(deck, data, False, run)
    sim = grid.sim
    assert sim._ctx.bonded_grid and not view.sim._ctx.bonded_grid
    if name == "water_shake":
        assert "_shk_mtags" in sim._carry[0].peratom
        assert "_shk_mtags" not in (view.sim._carry[0].peratom or {})
    xg, vg = tag_order(sim.state, "x", "v")
    xv, vv = tag_order(view.sim.state, "x", "v")
    np.testing.assert_allclose(xg, xv, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vg, vv, rtol=0, atol=1e-10)
    rows = [ln.split() for ln in sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]
    jlog = tpumd_log(deck, data, run)
    assert [r[0] for r in rows] == [r[0] for r in jlog] == ["0", "5", "10"]
    for a, b in zip(rows, jlog):
        np.testing.assert_allclose(np.array(a[1:], float),
                                   np.array(b[1:], float), rtol=1e-10,
                                   atol=1e-9)


def tpumd_log(deck, data, run):
    script = tpumd_sim(deck, data, run)
    return [ln.split() for ln in script.sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]


def test_lost_tuple_member_raises(tmp_path):
    deck, data = deck_of("chain", tmp_path)
    script = port_sim(deck, data)
    sim = script.sim
    s, neigh, fs = sim._carry
    utags = s.peratom["_bt_utags"].clone()
    slot = int(neigh.row2slot[0])
    # tag 1's second member (tag 2) becomes a tag no atom holds
    col = int(torch.nonzero(utags[slot] == 2)[0])
    utags[slot, col] = sim.natoms + 7
    sim._carry = (s.replace(peratom={**s.peratom, "_bt_utags": utags}),
                  neigh, fs)
    with pytest.raises(RuntimeError, match=f"lost a member.*"
                       f"{sim.natoms + 7}"):
        script.run_string("run 2")


def test_lost_shake_member_raises(tmp_path):
    deck, data = deck_of("water_shake", tmp_path)
    script = port_sim(deck, data)
    sim = script.sim
    s, neigh, fs = sim._carry
    mtags = s.peratom["_shk_mtags"].clone()
    mtags[int(neigh.row2slot[0]), 1] = sim.natoms + 3
    sim._carry = (s.replace(peratom={**s.peratom, "_shk_mtags": mtags}),
                  neigh, fs)
    with pytest.raises(RuntimeError, match="fix 0: a SHAKE cluster lacked "
                                           "a member"):
        script.run_string("run 2")


def test_member_gap_of_the_water_box(both):
    """Every matched member of the water box sits within one O-H bond
    (1 A) and an H-H distance of its slot: the lookup found the tuple's
    image, not another."""
    sim = both["water_nve"][0].sim
    s = sim._carry[0]
    mpos, _, _, found = ct.match_members(s.x, s.tag, s.type, s.q,
                                         s.peratom["_bt_utags"])
    d = minimum_image(mpos - s.x[:, None, :], s.box)
    gap = float(torch.sqrt((d * d).sum(-1))[found].max())
    assert 0.9 < gap < 1.7


def test_special_partner_slots_on_a_local_grid(both):
    """The list kernel's special partners by slot (``partner_slots`` with
    the positions) on water_nve's local grids of two z-slabs, a halo atom
    in both halos: each owned slot's special partner is found at the copy
    within cutneigh, and it holds that tag."""
    from tpumd_torch.ops.cellgrid_pairlist import partner_slots
    from tpumd_torch.parallel.decomp import GridLayout, assemble_slots
    sim = both["water_nve"][0].sim
    s, neigh, _ = sim._carry
    cutneigh = sim._neigh_cfg.cutneigh
    for rank in range(2):
        lay = GridLayout(sim._neigh_cfg, 2, 1, rank)
        sl, vl = assemble_slots(lay, s, neigh.valid)
        own = vl & torch.as_tensor(lay.slot_maps[2])
        assert lay.copies == 2
        slots = partner_slots(sl.tag, sl.special_tags, sl.x)
        named = (sl.special_tags > 0) & own[:, None]
        assert bool(named.any()) and bool((slots[named] >= 0).all())
        hit = slots[named].long()
        assert torch.equal(sl.tag[hit], sl.special_tags[named])
        rows = torch.nonzero(named)[:, 0]
        d = sl.x[hit] - sl.x[rows]
        assert float(torch.sqrt((d * d).sum(-1)).max()) < cutneigh
