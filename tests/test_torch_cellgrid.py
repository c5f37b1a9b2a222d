"""Cell-grid binning of the port against tpumd.ops.cellgrid.

One numpy-seeded state (an fcc block with displaced atoms, rows shuffled
so that the stable sorts matter) goes through both packages in float64.
The slot order is a contract (forces are summed per slot, and the
trajectory's rounding follows it), so ``choose_cellgrid_config``, the
permutations ``perm``/``src``/``dst``/``row2slot`` and every permuted
array must be exactly equal (tolerance 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.core.state import make_state as j_make_state
from tpumd.core.state import minimum_image as j_minimum_image
from tpumd.core.state import wrap_pbc as j_wrap_pbc
from tpumd.ops import cellgrid as jcg
from tpumd_torch.core.state import minimum_image as t_minimum_image
from tpumd_torch.core.state import wrap_pbc as t_wrap_pbc
from tpumd_torch.interop import state_from_numpy
from tpumd_torch.ops import cellgrid as tcg

FIELDS = ("x", "v", "f", "type", "tag", "image")


def _seeded(nlat=6, seed=11):
    from tpumd_torch.core.create import create_atoms_lattice
    from tpumd_torch.core.lattice import Lattice
    rng = np.random.default_rng(seed)
    lat = Lattice("fcc", 0.8442)
    hi = nlat * lat.spacing
    x, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    n = len(x)
    x = x + rng.uniform(-0.6, 0.6, x.shape)   # some atoms leave the box
    order = rng.permutation(n)
    arrays = {"x": x[order], "v": rng.normal(size=(n, 3)),
              "f": rng.normal(size=(n, 3)),
              "type": np.where(rng.random(n) < 0.3, 2, 1).astype(np.int32),
              "tag": (np.arange(n) + 1)[order].astype(np.int32),
              "image": rng.integers(-2, 3, (n, 3)).astype(np.int32)}
    return arrays, {"lo": np.zeros(3), "hi": hi}


def _pair(arrays, box):
    js = j_make_state(arrays["x"], arrays["v"], arrays["type"],
                      JBox.orthogonal(box["lo"], box["hi"],
                                      dtype=jnp.float64),
                      tags=arrays["tag"], image=arrays["image"],
                      dtype=jnp.float64)
    js = js.replace(f=jnp.asarray(arrays["f"]))
    ts = state_from_numpy(arrays, box, device="cpu", dtype=torch.float64)
    return js, ts


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy())


def _eq_state(js, ts):
    for k in FIELDS:
        _eq(getattr(js, k), getattr(ts, k))


def _cfg(jbox, tbox, natoms, **kw):
    jc = jcg.choose_cellgrid_config(jbox, 2.8, 0.3, natoms, **kw)
    tc = tcg.choose_cellgrid_config(tbox, 2.8, 0.3, natoms, **kw)
    return jc, tc


def _binned(cap=None):
    arrays, box = _seeded()
    js, ts = _pair(arrays, box)
    js, ts = j_wrap_pbc(js), t_wrap_pbc(ts)
    n = len(arrays["x"])
    jc, tc = _cfg(js.box, ts.box, n, cap=cap, every=20, delay=0,
                  check=False)
    js, ts = jcg.pad_state(js, jc.capacity), tcg.pad_state(ts, tc.capacity)
    jv0 = jnp.arange(jc.capacity) < n
    tv0 = torch.arange(tc.capacity) < n
    jout = jcg.bin_permutation(js.x, jv0, js.box, jc)
    tout = tcg.bin_permutation(ts.x, tv0, ts.box, tc)
    return js, ts, jc, tc, jout, tout, n


def case_config():
    arrays, box = _seeded()
    js, ts = _pair(arrays, box)
    for kw in ({}, {"cap": 24}, {"box_margin": 2.0},
               {"every": 20, "delay": 0, "check": False}):
        for n in (864, 32000):
            jc, tc = _cfg(js.box, ts.box, n, **kw)
            assert dataclasses.asdict(jc) == {
                **dataclasses.asdict(tc), "exclude_bits": ()}


def case_wrap_and_minimum_image():
    arrays, box = _seeded()
    js, ts = _pair(arrays, box)
    _eq_state(j_wrap_pbc(js), t_wrap_pbc(ts))
    d = np.random.default_rng(3).uniform(-20, 20, (500, 3))
    _eq(j_minimum_image(jnp.asarray(d), js.box),
        t_minimum_image(torch.as_tensor(d), ts.box))


def case_bin_permutation():
    js, ts, jc, tc, jout, tout, n = _binned()
    for j, t in zip(jout, tout):
        _eq(j, t)
    _eq_state(jcg.apply_permutation(js, jout[0], jout[1]),
              tcg.apply_permutation(ts, tout[0], tout[1]))


def _rebin(row2slot_given: bool, crowd: int = 0):
    js, ts, jc, tc, jout, tout, n = _binned()
    js = jcg.apply_permutation(js, jout[0], jout[1])
    ts = tcg.apply_permutation(ts, tout[0], tout[1])
    # move every atom, as a rebuild would find them
    dx = np.random.default_rng(9).uniform(-0.9, 0.9, (jc.capacity, 3))
    dx = dx * (np.asarray(jout[1])[:, None])
    # crowd the first `crowd` atoms into one cell
    slots = np.flatnonzero(np.asarray(jout[1]))[:crowd]
    dx[slots] += 1.0 + 0.01 * np.arange(crowd)[:, None] \
        - np.asarray(js.x)[slots]
    js = j_wrap_pbc(js.replace(x=js.x + jnp.asarray(dx)))
    ts = t_wrap_pbc(ts.replace(x=ts.x + torch.as_tensor(dx)))
    jr = tr = None
    if row2slot_given:
        jr = jcg.row2slot_from_tags(js.tag, n)
        tr = tcg.row2slot_from_tags(ts.tag, n)
        _eq(jr, tr)
    jo = jcg.bin_compact(js.x, js.tag, n, js.box, jc, row2slot=jr)
    to = tcg.bin_compact(ts.x, ts.tag, n, ts.box, tc, row2slot=tr)
    for j, t in zip(jo, to):     # src, dst, row2slot, max_count, overflow
        _eq(j, t)
    _eq_state(jcg.apply_permutation_compact(js, jo[0], jo[1], jc.capacity),
              tcg.apply_permutation_compact(ts, to[0], to[1], tc.capacity))
    return bool(to[4])


def case_bin_compact_tags():
    assert not _rebin(False)


def case_bin_compact_row2slot():
    assert not _rebin(True)


def case_bin_compact_overflow():
    # a cap below the occupancy drops atoms (dst == capacity) in both
    assert _rebin(True, crowd=80)


def case_compact_state():
    js, ts, jc, tc, jout, tout, n = _binned()
    js = jcg.apply_permutation(js, jout[0], jout[1])
    ts = tcg.apply_permutation(ts, tout[0], tout[1])
    _eq_state(jcg.compact_state(js, jout[1], n),
              tcg.compact_state(ts, tout[1], n))


CASES = {k[5:]: v for k, v in globals().items() if k.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cellgrid_matches_tpumd(case):
    CASES[case]()
