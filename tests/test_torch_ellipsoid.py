"""atom_style ellipsoid in the port (core/atomvec.py, io/read_data.py,
io/restart.py) against tpumd's, on the CPU in f64.

* tests/test_atomvec.py's data file: the same flags, rmass, semi-axes,
  normalised quaternions and angular momenta from both readers.
* The deck's state: the fields ride MDState and equal tpumd's extras; a
  restart file round trip keeps them (and tpumd reads the port's file).
* bench_targets' ellipsoid liquid (125 atoms) runs as points of their
  mass: 20 steps on the grid and on the matrix engine equal tpumd's rows,
  and the fields, padded and permuted with the atoms, come back by tag.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tpumd.io.read_data import read_data as jread
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.io.read_data import read_data as tread
from tpumd_torch.io.restart import read_restart, tag_ordered, write_restart
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

# tests/test_atomvec.py's file
DATA = """ellipsoid test

3 atoms
2 ellipsoids
1 atom types

0.0 10.0 xlo xhi
0.0 10.0 ylo yhi
0.0 10.0 zlo zhi

Masses

1 1.0

Atoms # ellipsoid

1 1 1 0.5 1.0 1.0 1.0
2 1 1 2.0 2.0 2.0 2.0
3 1 0 3.0 3.0 3.0 3.0

Ellipsoids

1 2.0 1.0 1.0 1.0 0.0 0.0 0.0
2 1.0 1.0 1.0 0.0 1.0 0.0 0.0

Velocities

1 0.1 0.0 0.0 0.01 0.02 0.03
2 0.0 0.0 0.0 0.0 0.0 0.0
3 0.0 0.0 0.0 0.0 0.0 0.0
"""

FIELDS = ("ellipsoid", "shape", "quat", "angmom", "torque")
KEYS = ("temp", "epair", "etotal", "press")


def write(tmp_path):
    p = tmp_path / "data.ell"
    p.write_text(DATA)
    return p


def test_data_file_equals_tpumd(tmp_path):
    p = write(tmp_path)
    d, j = tread(str(p), "ellipsoid"), jread(str(p), atom_style="ellipsoid")
    assert d.nellipsoids == j.nellipsoids == 2
    np.testing.assert_array_equal(d.rmass, j.rmass)
    assert np.isclose(d.rmass[0], 0.5 * 4 * np.pi / 3 * 1.0 * 0.5 * 0.5)
    assert d.rmass[2] == 3.0
    assert sorted(d.fields) == sorted(j.fields) == sorted(FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(d.fields[k], j.fields[k])
    np.testing.assert_array_equal(d.fields["shape"][0], [1.0, 0.5, 0.5])
    np.testing.assert_array_equal(d.v, j.v)
    np.testing.assert_array_equal(d.x, j.x)


def deck(p):
    return (f"units lj\natom_style ellipsoid\nread_data {p}\nmass 1 1.0\n"
            "pair_style lj/cut 2.5\npair_coeff 1 1 1.0 1.0 2.5\n")


def test_state_and_restart(tmp_path):
    p = write(tmp_path)
    t = TScript(device="cpu", dtype=torch.float64)
    j = JScript()
    with contextlib.redirect_stdout(io.StringIO()):
        t.run_string(deck(p))
        j.run_string(deck(p))
    st, jt = t.sim.state, j.sim.state
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(jt.extras[k]))
    assert st.ellipsoid.dtype == torch.int32
    np.testing.assert_array_equal(st.rmass.numpy(), np.asarray(jt.rmass))
    rp = str(tmp_path / "r.npz")
    write_restart(t.sim, rp)
    t2 = TScript(device="cpu", dtype=torch.float64)
    t2.run_string("units lj\natom_style ellipsoid\n")
    read_restart(t2.sim, rp)
    a, b = tag_ordered(t.sim), t2.sim.state
    for k in FIELDS + ("rmass", "x", "v"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    # tpumd reads the port's file
    from tpumd.io.restart import read_restart as jread_restart
    j2 = JScript()
    j2.run_string("units lj\natom_style ellipsoid\n")
    jread_restart(j2.sim, rp)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(j2.sim.state.extras[k]),
                                      getattr(a, k).numpy())


@pytest.mark.parametrize("mode", ["cellgrid", "matrix"])
def test_liquid_runs_as_points(mode, tmp_path):
    data = tmp_path / "data.ell"
    n = bt.ellipsoid_data(str(data), 5)
    text = bt.IN_ELLIPSOID.format(data=data)
    j, t = JScript(), TScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(io.StringIO()):
        j.run_string(text + "run 20\n")
        t.run_string(text)
        t.sim.neighbor_mode = mode
        before = {k: getattr(tag_ordered(t.sim), k).clone() for k in FIELDS}
        t.run_string("run 20\n")
    assert t.sim.natoms == n == 125
    assert t.sim._ctx.is_cellgrid == (mode == "cellgrid")
    jrows = {int(r["step"]): r for r in j.sim.thermo_rows}
    trows = {int(r["step"]): r for r in t.sim.thermo_rows}
    assert sorted(trows) == sorted(jrows) == [0, 10, 20]
    for step in trows:
        for k in KEYS:
            assert trows[step][k] == pytest.approx(
                float(jrows[step][k]), rel=1e-10, abs=1e-12), (step, k)
    after = tag_ordered(t.sim)
    for k in FIELDS:
        assert torch.equal(getattr(after, k), before[k]), k
    jtag = np.asarray(j.sim.state.tag)
    order = np.argsort(jtag)
    jx = np.asarray(j.sim.state.x)[order][jtag[order] > 0]
    np.testing.assert_allclose(after.x.numpy(), jx, rtol=0, atol=1e-10)
