"""The port's temper command and -partition (md/temper.py, the world
variables of script/parser.py, __main__.py) against tpumd's, on the CPU in
f64.

* tests/test_temper.py's deck (4^3 fcc cells, four replicas at T 0.7-1.0,
  fix nvt, ``temper 120 30 $t 1 3847 58382``) through tpumd's sequential
  path (the path its own test holds its batched one to) and the port: the
  same accepted and attempted swaps each window, every replica's printed
  thermo rows equal, the final positions in tag order to 1e-10, each
  replica's thermostat target its world value.
* A swap between replicas whose neighbour configs differ re-bins both, and
  each replica then sweeps a list built for its own positions.
* A 2-world deck through both command lines with ``-partition 2x1 -plog``:
  the log.lammps.N files equal but their timing lines (ROADMAP C6).
"""

import numpy as np
import pytest
import torch

import tpumd.md.temper as jtemper
from tpumd.__main__ import main as jmain
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.__main__ import main as tmain
from tpumd_torch.md.temper import swap_configurations
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
DECK = """
units           lj
atom_style      atomic
variable        t world 0.7 0.8 0.9 1.0
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create $t 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 5 check no
fix             1 all nvt temp $t $t 0.5
temper          120 30 $t 1 3847 58382
"""


def tag_x(state):
    x = state.x
    tag = state.tag
    if torch.is_tensor(x):
        x, tag = x.double().numpy(), tag.numpy()
    else:
        x, tag = np.asarray(x, np.float64), np.asarray(tag)
    out = np.zeros((int((tag > 0).sum()), 3))
    out[tag[tag > 0] - 1] = x[tag > 0]
    return out


def thermo_rows(lines):
    return [ln for ln in lines if ln.split() and ln.split()[0].isdigit()]


@pytest.fixture(scope="module")
def tempered():
    mp = pytest.MonkeyPatch()
    mp.setattr(jtemper, "_can_batch", lambda sims: False)
    try:
        j = JScript()
        j.run_string(DECK)
    finally:
        mp.undo()
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(DECK)
    return j, t


def test_temper_swaps_equal(tempered):
    j, t = tempered
    assert t.temper_accepts == j.temper_accepts
    assert sum(n for _, n in t.temper_accepts) >= 4
    assert sum(a for a, _ in t.temper_accepts) >= 1


def test_temper_replicas_equal(tempered):
    j, t = tempered
    assert len(t.replicas) == 4
    for k, (js, ts) in enumerate(zip(j.replicas, t.replicas)):
        assert ts.step == js.step == 120
        jr, tr = thermo_rows(js.log_lines), thermo_rows(ts.log_lines)
        assert len(tr) == len(jr) > 0
        for a, b in zip(tr, jr):
            np.testing.assert_allclose([float(v) for v in a.split()],
                                       [float(v) for v in b.split()],
                                       rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(tag_x(ts.state), tag_x(js.state),
                                   rtol=0, atol=1e-10)
        assert ts.fixes[0].t_start == [0.7, 0.8, 0.9, 1.0][k]


def test_temper_swap_rebins_on_other_config():
    """Replicas whose grids differ (one grown) exchange states by re-bin:
    each then runs on; its forces equal a fresh set-up's of its state."""
    deck = DECK.replace("temper          120 30 $t 1 3847 58382", "")
    sims = []
    for w in range(2):
        sc = TScript(device="cpu", dtype=torch.float64)
        sc._world_index = w
        sc.run_string(deck.replace("block 0 4 0 4 0 4", "block 0 6 0 6 0 6")
                      + "run 5\n")
        sims.append(sc.sim)
    a, b = sims
    b._kmax_override = b._ctx.pairlist_k + 16
    b._rebin(b._carry)
    assert a._ctx.pairlist_k != b._ctx.pairlist_k
    xa, xb = tag_x(a._carry[0]), tag_x(b._carry[0])
    swap_configurations(a, b, 0.7, 0.8)
    np.testing.assert_array_equal(tag_x(a._carry[0]), xb)
    np.testing.assert_array_equal(tag_x(b._carry[0]), xa)
    for sim in sims:
        assert sim._carry[1].pairs.shape[1] == sim._ctx.pairlist_k
        sim.run(5)
        f = tag_x(sim._carry[0].replace(x=sim._carry[0].f))
        sim.invalidate_ctx()
        sim.setup()
        np.testing.assert_allclose(
            f, tag_x(sim._carry[0].replace(x=sim._carry[0].f)), rtol=0,
            atol=1e-9)


PART_DECK = """
variable        t world 1.0 1.5
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 3 0 3 0 3
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create $t 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
fix             1 all nve
thermo          10
run             20
"""


def test_partition_logs_equal(tmp_path):
    deck = tmp_path / "in.part"
    deck.write_text(PART_DECK)
    jmain(["-in", str(deck), "-partition", "2x1", "-plog",
           str(tmp_path / "j.log")])
    tmain(["-in", str(deck), "-partition", "2x1", "-plog",
           str(tmp_path / "t.log"), "--device", "cpu", "--dtype", "f64"])

    def lines(p):
        return [ln for ln in p.read_text().splitlines()
                if not ln.startswith(("Loop time", "Performance"))]
    temps = []
    for w in range(2):
        jl, tl = lines(tmp_path / f"j.log.{w}"), lines(tmp_path / f"t.log.{w}")
        assert tl == jl
        temps.append(float(thermo_rows(tl)[0].split()[1]))
    assert temps == [1.0, 1.5]
