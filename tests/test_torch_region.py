"""Regions, the velocity styles and the group styles against tpumd.

The same deck goes through tpumd's and the port's LammpsScript (f64, on
the CPU; no run): every region style selects the same atoms for
create_atoms and group, in lattice and box units, with side out and as
union and intersect; velocity set, scale, ramp and zero linear on groups
give the same velocities; group id, union, intersect and subtract give the
same membership bits.  What the port takes beyond tpumd (zero angular,
rot yes, sum yes, units lattice spelled out) is checked against its
definition, as are units box on ramp, which tpumd scales by the lattice
whatever the keyword says.
"""

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.script.parser import LammpsScript as TScript

HEAD = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 6 0 6 0 6
create_box      1 box
mass            1 1.0
"""

# region lines of every style, each named r, in lattice units (the
# default) or box units; the helpers b1 and b2 feed union and intersect
REGIONS = {
    "block": "region r block 1 4 INF 3 2 EDGE",
    "block_box": "region r block 1.5 5.5 0 4 2 7 units box",
    "sphere": "region r sphere 3 3 3 2.2",
    "sphere_out": "region r sphere 3 3 3 2.2 side out",
    "prism": "region r prism 0 5 0 5 0 5 1.0 0.5 0.0",
    "cylinder": "region r cylinder z 3 3 2.0 1 5",
    "cylinder_x_inf": "region r cylinder x 3 2.5 1.5 INF EDGE",
    "cone": "region r cone y 3 3 1.0 2.5 0 6",
    "plane": "region r plane 3 3 3 1 1 0",
    "ellipsoid": "region r ellipsoid 3 3 3 2.5 1.5 2.0",
    "ellipsoid_box": "region r ellipsoid 5 5 5 3 2 4 units box",
    "union": "region b1 block 0 2 0 6 0 6\nregion b2 sphere 4 4 4 1.5\n"
             "region r union 2 b1 b2",
    "intersect": "region b1 block 0 4 0 6 0 6\nregion b2 sphere 3 3 3 2.5\n"
                 "region r intersect 2 b1 b2 side out",
}


def _both(deck):
    j = JScript()
    j.run_string(deck)
    j._finalize_atoms()
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    t._finalize_atoms()
    return j.sim.state, t.sim.state


def _sorted_x(x):
    x = np.asarray(x, np.float64)
    return x[np.lexsort(x.T[::-1])]


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_region_selects_as_tpumd(name):
    """create_atoms region and group region take the same atoms."""
    js, ts = _both(HEAD + REGIONS[name] + "\ncreate_atoms 1 region r\n")
    assert 0 < ts.x.shape[0] < 864
    np.testing.assert_array_equal(_sorted_x(ts.x.numpy()),
                                  _sorted_x(js.x))
    js, ts = _both(HEAD + REGIONS[name]
                   + "\ncreate_atoms 1 box\ngroup g region r\n")
    np.testing.assert_array_equal(ts.gmask.numpy(), np.asarray(js.gmask))
    assert 0 < int((ts.gmask.numpy() & 2).astype(bool).sum()) < 864


def test_region_units_lattice_spelled_out_and_errors():
    """units lattice names the default (tpumd reads any units keyword as
    box); a keyword neither package takes, and an unknown style, raise."""
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(HEAD + "region a sphere 3 3 3 2 units lattice\n"
                 "region b sphere 3 3 3 2\n")
    a, b = t.regions["a"], t.regions["b"]
    np.testing.assert_array_equal(a.center, b.center)
    assert a.radius == b.radius
    for line, err in (("region c sphere 3 3 3 2 move v_x NULL NULL",
                       NotImplementedError),
                      ("region c wedge 0 0 1", NotImplementedError),
                      ("region c union 2 a nope", Exception)):
        with pytest.raises(err):
            t.execute(line)


VEL = HEAD + """create_atoms 1 box
group lowz region lo
velocity all create 1.3 4928 loop geom
velocity lowz set 0.5 NULL -0.2
velocity all set NULL 0.25 NULL units box
velocity lowz scale 2.5
velocity all ramp vz -0.4 0.7 x 1 5
velocity lowz ramp vx 0.1 0.3 y 0 4
velocity lowz zero linear
"""


def test_velocity_styles_as_tpumd():
    deck = VEL.replace("group lowz region lo",
                       "region lo block INF INF INF INF 0 2.5\n"
                       "group lowz region lo")
    js, ts = _both(deck)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-15,
                               atol=1e-15)
    low = (ts.gmask.numpy() & 2) > 0
    m = np.ones(len(low))
    p = (m[low, None] * ts.v.numpy()[low]).sum(0)
    np.testing.assert_allclose(p, 0.0, atol=1e-11)


def test_velocity_beyond_tpumd():
    """zero angular removes the group's rigid rotation and keeps its
    momentum; create with rot yes has no angular momentum; sum yes adds;
    what tpumd refuses the port refuses, naming it."""
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(HEAD + "create_atoms 1 box\n"
                 "region lo block INF INF INF INF 0 2.5\n"
                 "group lowz region lo\n"
                 "velocity all create 1.0 77 loop geom rot yes\n")
    s = t.sim.state
    xu = t._unwrapped()
    v = s.v.numpy()
    xc = xu - xu.mean(0)
    np.testing.assert_allclose(np.cross(xc, v).sum(0), 0.0, atol=1e-11)
    np.testing.assert_allclose(v.sum(0), 0.0, atol=1e-11)
    v0 = v.copy()
    t.execute("velocity all set 0.1 0.0 0.0 sum yes units box")
    np.testing.assert_allclose(t.sim.state.v.numpy() - v0,
                               np.tile([0.1, 0.0, 0.0], (len(v0), 1)),
                               atol=1e-15)
    # units box: the ramp in box lengths (tpumd scales it by the lattice
    # whatever the keyword says)
    t.execute("velocity lowz ramp vy 0.0 1.0 x 0 6 units box")
    low = (t.sim.state.gmask.numpy() & 2) > 0
    np.testing.assert_allclose(
        t.sim.state.v.numpy()[low, 1],
        np.clip(s.x.numpy()[low, 0] / 6.0, 0.0, 1.0), rtol=1e-15)
    p0 = t.sim.state.v.numpy()[low].sum(0)
    t.execute("velocity lowz zero angular")
    v = t.sim.state.v.numpy()[low]
    xl = xu[low] - xu[low].mean(0)
    np.testing.assert_allclose(np.cross(xl, v).sum(0), 0.0, atol=1e-10)
    np.testing.assert_allclose(v.sum(0), p0, atol=1e-10)
    for line, word in (("velocity lowz create 1.0 5 loop geom", "group"),
                       ("velocity all create 1.0 5 loop all", "loop geom"),
                       ("velocity all create 1.0 5 loop geom temp t",
                        "temp"),
                       ("velocity all flip 1", "flip")):
        with pytest.raises(NotImplementedError, match=word):
            t.execute(line)


GROUPS = HEAD + """create_atoms 1 box
region lo block INF INF INF INF 0 2.5
group lowz region lo
group a id 1:50 60 70:80 400
group b type 1
group c union a lowz
group d intersect a lowz b
group e subtract all a
group a2 id 700:864
group lowz union lowz a2
"""


def test_group_styles_as_tpumd():
    js, ts = _both(GROUPS)
    np.testing.assert_array_equal(ts.gmask.numpy(), np.asarray(js.gmask))
    gm = ts.gmask.numpy()
    tag = ts.tag.numpy()
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(GROUPS)
    bit = t.sim.groups
    a = ((tag >= 1) & (tag <= 50)) | (tag == 60) | (
        (tag >= 70) & (tag <= 80)) | (tag == 400)
    np.testing.assert_array_equal((gm & bit["a"]) > 0, a)
    np.testing.assert_array_equal((gm & bit["e"]) > 0, ~a)
    np.testing.assert_array_equal(
        (gm & bit["d"]) > 0, a & ((gm & bit["lowz"]) > 0) & (tag <= 400))
