"""Host-only modules of the port against tpumd: exact equality.

Units, the RanPark streams, lattices (including the spacing and origin
quirks of tpumd/core/lattice.py:120,134, which the port keeps), the block
region, create_atoms and ``velocity loop geom``.  These run in float64
numpy on the host in both packages with the same operation order, so
every case demands bit-equal results (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest

from tpumd.core import create as j_create
from tpumd.core import lattice as j_lattice
from tpumd.core import region as j_region
from tpumd.core import velocity_cmd as j_velocity
from tpumd.utils import ranpark as j_ranpark
from tpumd.utils import units as j_units
from tpumd_torch.core import create as t_create
from tpumd_torch.core import lattice as t_lattice
from tpumd_torch.core import region as t_region
from tpumd_torch.core import velocity_cmd as t_velocity
from tpumd_torch.utils import ranpark as t_ranpark
from tpumd_torch.utils import units as t_units

COORDS = np.random.default_rng(1234).uniform(-3.0, 40.0, (257, 3))


def _units():
    for name in j_units._UNITS:
        yield (dataclasses.asdict(j_units.get_units(name)),
               dataclasses.asdict(t_units.get_units(name)))


def _park_next():
    s = np.array([1, 87287, 2147483646, 12345, 999], dtype=np.int64)
    js, ts = s.copy(), s.copy()
    for _ in range(20):
        js, ju = j_ranpark.park_next(js)
        ts, tu = t_ranpark.park_next(ts)
        yield ju, tu
        yield js, ts


def _jenkins():
    for seed in (87287, 1, 2 ** 31 - 1):
        yield (j_ranpark.jenkins_coord_seed(seed, COORDS),
               t_ranpark.jenkins_coord_seed(seed, COORDS))


def _geom_triplets():
    yield (j_ranpark.geom_uniform_triplets(87287, COORDS),
           t_ranpark.geom_uniform_triplets(87287, COORDS))


def _ranpark_stream():
    jr, tr = j_ranpark.RanPark(87287), t_ranpark.RanPark(87287)
    yield ([jr.uniform() for _ in range(50)] + [jr.gaussian()
                                                for _ in range(51)],
           [tr.uniform() for _ in range(50)] + [tr.gaussian()
                                                for _ in range(51)])


def _lattice(style, scale, units, args=()):
    j = j_lattice.Lattice(style, scale, units=units, args=args)
    t = t_lattice.Lattice(style, scale, units=units, args=args)
    pts = np.random.default_rng(5).uniform(-2, 5, (33, 3))
    for attr in ("a1", "a2", "a3", "basis", "origin", "spacing"):
        yield getattr(j, attr), getattr(t, attr)
    yield j.scale, t.scale
    yield j.lattice2box(pts), t.lattice2box(pts)


def _lattices():
    for style in ("fcc", "bcc", "sc", "hcp", "diamond"):
        yield from _lattice(style, 0.8442, "lj")
        yield from _lattice(style, 3.615, "metal")


def _lattice_quirks():
    # ROADMAP C3: an explicit spacing is NOT multiplied by the lattice
    # scale, and origin is added in lattice coordinates.  Pinned here.
    t = t_lattice.Lattice("fcc", 0.8442, args=("spacing", "2", "2", "2"))
    assert t.scale != 1.0 and list(t.spacing) == [2.0, 2.0, 2.0]
    t = t_lattice.Lattice("fcc", 0.8442, args=("origin", "0.25", "0", "0"))
    assert t.lattice2box(np.zeros((1, 3)))[0, 0] == 0.25 * t.scale
    yield from _lattice("fcc", 0.8442, "lj", ("spacing", "2", "2", "2"))
    yield from _lattice("fcc", 0.8442, "lj", ("origin", "0.25", "0.5", "0"))


def _region():
    lo, hi = [0.5, -1.0, 2.0], [10.0, 3.0, 4.5]
    j, t = j_region.BlockRegion(lo, hi), t_region.BlockRegion(lo, hi)
    yield j.inside(COORDS), t.inside(COORDS)
    yield j.bounding_box(), t.bounding_box()


def _create_atoms():
    for n in (6, 20):
        jl = j_lattice.Lattice("fcc", 0.8442)
        tl = t_lattice.Lattice("fcc", 0.8442)
        hi = n * jl.spacing
        yield (j_create.create_atoms_lattice(jl, None, np.zeros(3), hi),
               t_create.create_atoms_lattice(tl, None, np.zeros(3), hi))
        rlo, rhi = np.array([1.0, 0.0, 2.0]), 0.6 * hi
        yield (j_create.create_atoms_lattice(
                   jl, j_region.BlockRegion(rlo, rhi), np.zeros(3), hi,
                   type_id=2, fill_box=False),
               t_create.create_atoms_lattice(
                   tl, t_region.BlockRegion(rlo, rhi), np.zeros(3), hi,
                   type_id=2, fill_box=False))


def _velocity():
    lat = t_lattice.Lattice("fcc", 0.8442)
    x, _ = t_create.create_atoms_lattice(lat, None, np.zeros(3),
                                         6 * lat.spacing)
    m = np.where(np.arange(len(x)) % 3 == 0, 2.0, 1.0)
    for dist in ("uniform", "gaussian"):
        for mom in (True, False):
            kw = dict(dist=dist, zero_momentum=mom)
            yield (j_velocity.velocity_create_geom(x, m, 1.44, 87287, **kw),
                   t_velocity.velocity_create_geom(x, m, 1.44, 87287, **kw))


CASES = {"units": _units, "park_next": _park_next, "jenkins": _jenkins,
         "geom_triplets": _geom_triplets, "ranpark_stream": _ranpark_stream,
         "lattices": _lattices, "lattice_quirks": _lattice_quirks,
         "region_block": _region, "create_atoms": _create_atoms,
         "velocity_loop_geom": _velocity}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a == b
    elif isinstance(a, (tuple, list)) and a and not np.isscalar(a[0]):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_module_bit_equal(case):
    pairs = list(CASES[case]())
    assert pairs
    for j, t in pairs:
        _assert_same(j, t)
