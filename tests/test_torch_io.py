"""Dumps, restarts, data files and the state-editing commands of the port
against tpumd.

Each case runs the same deck through tpumd (float64 on the CPU, its
matrix engine) and through tpumd_torch on the CPU in float64 (the cell
grid under "auto").  The decks check the displacement every step, so that
both engines sum every pair in range and differ by summation order only
(ROADMAP C2): thermo agrees to 1e-10 relative, dumped values to 1e-10 of
the column's largest, and printed rows are equal.  displace_atoms random
gives bit-equal positions.
"""

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

DECK = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 1 check yes
fix             1 all nve
"""
KEYS = ("temp", "epair", "etotal", "press")
RTOL = 1e-10


def both(tmp_path=None):
    """A tpumd script and a port script (CPU, f64) reading files
    relative to tmp_path."""
    j = JScript(data_dir=str(tmp_path or "."))
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path or ".")
    return j, t


def quiet(s, text):
    s.run_string(text)
    s.sim.verbose = False


def rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


def assert_thermo(a, b, keys=KEYS):
    for k in keys:
        assert b[k] == pytest.approx(a[k], rel=RTOL, abs=1e-12), k


def parse_dump(path):
    """{step: (header lines, rows)} of a text dump."""
    out = {}
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        step, n = int(lines[i + 1]), int(lines[i + 3])
        header = lines[i:i + 9]
        header = header[:1] + header[2:5] + header[8:]   # step, n in keys
        out[step] = (header, np.loadtxt(lines[i + 9:i + 9 + n]).reshape(n, -1))
        i += 9 + n
    return out


def test_dump_custom_sorted(tmp_path):
    """dump custom with sort id, written at 15 digits: the same headers
    and steps as tpumd's, values to 1e-10 of max(1, the column's
    largest)."""
    dumps = []
    for s, name in zip(both(tmp_path), ("j.dump", "t.dump")):
        quiet(s, DECK + f"dump 1 all custom 5 {name} id type x y z vx fx\n"
              "dump_modify 1 sort id format float %20.15g\n")
        s.run_string("run 12")
        dumps.append(parse_dump(tmp_path / name))
    assert sorted(dumps[0]) == sorted(dumps[1]) == [0, 5, 10]
    for step in dumps[0]:
        (ha, a), (hb, b) = dumps[0][step], dumps[1][step]
        assert ha == hb
        np.testing.assert_array_equal(b[:, 0], np.arange(1, 257))
        # step 0's lattice forces cancel to ~1e-14: scale at least 1
        scale = np.maximum(np.abs(a).max(axis=0), 1.0)
        assert (np.abs(b - a) <= 1e-10 * scale).all(), step


def test_dump_atom_every_and_undump(tmp_path):
    """dump atom (scaled coordinates), dump_modify every, a file per step
    and undump: the same files and snapshots as tpumd's."""
    for s, tag in zip(both(tmp_path), "jt"):
        quiet(s, DECK + f"dump d all atom 4 {tag}.*.atom\n"
              "dump_modify d every 3 sort id\n")
        s.run_string("run 7\nundump d\nrun 3")
    for step in (0, 3, 6):
        a = parse_dump(tmp_path / f"j.{step}.atom")[step]
        b = parse_dump(tmp_path / f"t.{step}.atom")[step]
        assert a[0] == b[0]
        np.testing.assert_allclose(b[1], a[1], rtol=0, atol=1e-10)
    assert not (tmp_path / "t.9.atom").exists()
    assert not (tmp_path / "j.9.atom").exists()


def test_restart_round_trip(tmp_path):
    """tests/test_api_io.py::test_dump_and_restart through the port: the
    continuation of a read restart equals the uninterrupted run."""
    s = TScript(device="cpu", dtype=torch.float64)
    quiet(s, DECK.replace("every 1 check yes", "every 5 check no"))
    s.run_string(f"run 5\nwrite_restart {tmp_path}/state.npz")
    e_before = s.sim.last_thermo["etotal"]
    s2 = TScript(device="cpu", dtype=torch.float64)
    quiet(s2, "units lj\natom_style atomic\npair_style lj/cut 2.5\n"
          "neighbor 0.3 bin\nneigh_modify delay 0 every 5 check no\n"
          "fix 1 all nve\n")
    s2.run_string(f"read_restart {tmp_path}/state.npz\n"
                  "pair_coeff 1 1 1.0 1.0 2.5\nrun 0")
    assert s2.sim.step == 5 and s2.sim.natoms == 256
    assert s2.sim.last_thermo["etotal"] == pytest.approx(e_before,
                                                         rel=1e-12)
    s.run_string("run 5")
    s2.run_string("run 5")
    assert_thermo(s.sim.last_thermo, s2.sim.last_thermo)


def test_restart_from_tpumd(tmp_path):
    """A restart that tpumd wrote, read by the port and continued 20
    steps, gives tpumd's continuation."""
    j = JScript()
    quiet(j, DECK)
    j.run_string(f"run 5\nwrite_restart {tmp_path}/j.npz\nrun 20")
    t = TScript(device="cpu", dtype=torch.float64)
    quiet(t, "units lj\natom_style atomic\npair_style lj/cut 2.5\n"
          "neighbor 0.3 bin\nneigh_modify delay 0 every 1 check yes\n"
          "fix 1 all nve\n")
    t.run_string(f"read_restart {tmp_path}/j.npz\n"
                 "pair_coeff 1 1 1.0 1.0 2.5\nrun 20")
    assert t.sim.step == j.sim.step == 25
    assert_thermo(j.sim.last_thermo, t.sim.last_thermo)


def test_restart_fix_state_raises(tmp_path):
    """A tpumd restart whose fix carries state (Nose-Hoover chains) raises
    in the port, naming the fix."""
    j = JScript()
    quiet(j, DECK.replace("fix             1 all nve",
                          "fix             th all nvt temp 1.0 1.0 0.5"))
    j.run_string(f"run 2\nwrite_restart {tmp_path}/nvt.npz")
    t = TScript(device="cpu", dtype=torch.float64)
    quiet(t, "units lj\natom_style atomic\npair_style lj/cut 2.5\n"
          "fix th all nvt temp 1.0 1.0 0.5\n")
    with pytest.raises(NotImplementedError, match="fix th"):
        t.execute(f"read_restart {tmp_path}/nvt.npz")


def test_write_data(tmp_path):
    """Before a run both packages write the same data file; after a run
    the port's (tag order, from the grid's slots) holds the atoms and
    velocities of tpumd's to 1e-10."""
    texts = []
    for s, tag in zip(both(tmp_path), "jt"):
        quiet(s, DECK)
        s.run_string(f"write_data {tag}0.data\nrun 3\nwrite_data {tag}3.data")
        texts.append([(tmp_path / f"{tag}{k}.data").read_text()
                      for k in (0, 3)])
    assert texts[0][0] == texts[1][0]
    a, b = (t[1].splitlines() for t in texts)
    assert len(a) == len(b) and "256 atoms" in a[2]
    for la, lb in zip(a, b):
        pa, pb = la.split(), lb.split()
        try:
            va, vb = np.array(pa, float), np.array(pb, float)
        except ValueError:
            assert la == lb
            continue
        np.testing.assert_allclose(vb, va, rtol=1e-10, atol=1e-12)


def test_displace_random_bit_equal():
    xs = []
    for s in both():
        quiet(s, DECK + "displace_atoms all random 0.1 0.2 0.3 7771\n"
              "displace_atoms all move 0.01 0 -0.02 units box\n")
        s._finalize_atoms()
        x = np.asarray(s.sim.state.x, np.float64)
        tag = np.asarray(s.sim.state.tag)
        xs.append(x[np.argsort(tag)])
    assert (xs[0] == xs[1]).all()


def edit_after_run(s):
    """tpumd edits its state after a run only where the set-up is dropped
    first: its invalidate_ctx puts the carried state back over an edit
    made before it (ROADMAP C9).  The port drops it itself."""
    if isinstance(s, JScript):
        s.sim.invalidate_ctx()


def test_displace_after_run():
    """displace_atoms after a run, of a group made then (a slab of the box
    by region): the port writes by tag, re-bins and rebuilds the list
    before the next run.  (The random style hashes each atom's coordinates
    bit for bit, so after a run, where the two packages' positions differ
    by summation order, it would draw other numbers in each.)"""
    out = []
    for s in both():
        quiet(s, DECK)
        s.run_string("run 5")
        edit_after_run(s)
        s.run_string("region slab block 0 1.5 INF INF INF INF\n"
                     "group slab region slab\n"
                     "displace_atoms slab move 0.13 -0.4 0.27 units box\n"
                     "run 5")
        out.append(s.sim.last_thermo)
    assert_thermo(*out)


def test_set_type_after_run():
    """set atom 1:40 type 2 after a run, on a two-type deck (the port
    takes it on the matrix engine): thermo as tpumd's."""
    deck = DECK.replace("create_box      1 box", "create_box      2 box") \
        .replace("mass            1 1.0", "mass            * 1.0\n"
                 "mass            2 3.0") \
        .replace("pair_coeff      1 1 1.0 1.0 2.5",
                 "pair_coeff      * * 1.0 1.0 2.5\n"
                 "pair_coeff      2 2 1.5 0.9 2.5")
    out = []
    for s in both():
        quiet(s, deck)
        s.run_string("run 5")
        edit_after_run(s)
        s.run_string("set atom 1:40 type 2\nset type 2 charge 0.5\nrun 10")
        out.append(s.sim.last_thermo)
        typ = np.asarray(s.sim.state.type)
        tag = np.asarray(s.sim.state.tag)
        assert ((typ == 2) == ((tag >= 1) & (tag <= 40))).all()
    assert_thermo(*out)


def test_unfix_mid_script():
    out = []
    for s in both():
        quiet(s, DECK.replace("fix             1 all nve",
                              "fix             1 all nvt temp 1.0 1.0 0.5"))
        s.run_string("run 5\nunfix 1\nfix 2 all nve\nrun 5")
        out.append(s.sim.last_thermo)
        assert [fx.id for fx in s.sim.fixes] == ["2"]
    assert_thermo(*out)
    t = both()[1]
    quiet(t, DECK)
    with pytest.raises(Exception, match="nofix"):
        t.execute("unfix nofix")


def test_delete_atoms_region():
    out = []
    for s in both():
        quiet(s, DECK.replace("velocity", "region hole block 0 1 0 1 0 2\n"
                              "delete_atoms region hole\nvelocity"))
        s.run_string("run 5")
        out.append((s.sim.natoms, s.sim.last_thermo, rows(s.sim)))
    assert out[0][0] == out[1][0] == 233
    assert_thermo(out[0][1], out[1][1])


def test_reset_timestep():
    out = []
    for s in both():
        quiet(s, DECK + "thermo 2\n")
        s.run_string("run 4\nreset_timestep 100\nrun 4")
        out.append(rows(s.sim))
        assert s.sim.step == 104
    steps = [[ln.split()[0] for ln in r if ln.split()[0].isdigit()]
             for r in out]
    assert steps[0] == steps[1] == ["0", "2", "4", "100", "102", "104"]


def test_port_restart_fix_state_raises(tmp_path):
    """Reading its own file whose fix carries state the port does not
    restore (fix langevin's RanMars stream) raises, naming the fix; fix
    nvt's chains are restored (tests/test_torch_output_remainders.py)."""
    for fixes in ("fix 1 all nve\nfix th all langevin 1.0 1.0 0.5 4871",):
        s = TScript(device="cpu", dtype=torch.float64)
        quiet(s, DECK.replace("fix             1 all nve", fixes))
        s.run_string(f"run 2\nwrite_restart {tmp_path}/p.npz")
        t = TScript(device="cpu", dtype=torch.float64)
        quiet(t, "units lj\natom_style atomic\npair_style lj/cut 2.5\n")
        with pytest.raises(NotImplementedError, match="fix th"):
            t.execute(f"read_restart {tmp_path}/p.npz")


@pytest.mark.parametrize("line,err,match", [
    ("dump 2 all xtc 5 d.xtc", NotImplementedError, "xtc"),
    ("dump 2 all custom 5 d.txt id proc", NotImplementedError, "proc"),
    ("dump 2 all custom 5 d.gz id x", NotImplementedError, "gzip"),
    ("set atom 1 type 3", Exception, "atom type"),
    ("set atom 1 mass 2.0", NotImplementedError, "mass"),
    ("displace_atoms nogroup move 1 0 0", Exception, "nogroup"),
    ("displace_atoms all rotate 0 0 0 0 0 1 90", NotImplementedError,
     "rotate"),
    ("delete_atoms group all", NotImplementedError, "delete_atoms"),
    ("dimension 4", Exception, "dimension"),
    ("variable v uloop 3", NotImplementedError, "uloop"),
    ("run 10 start 0", NotImplementedError, "run"),
])
def test_rejected_input_names_itself(line, err, match, tmp_path):
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    quiet(t, DECK)
    with pytest.raises(err, match=match):
        t.execute(line)
