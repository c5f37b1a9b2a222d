"""The port decomposed over 4 gloo ranks against tpumd's sharded run on
the CPU, in f64 (``tpumd_torch/parallel/``): in.lj re-binned every 5
steps (``neigh_modify every 5 check no``), 10 steps from the set-up on
the cell grid, so both runs cross the re-bins of steps 5 and 10 (the
port's migration and halo slot refill).  8^3 fcc cells (2,048 atoms, a
4^3 cell grid) run as 4 z-slabs; 6^3 cells (864 atoms, a 3^3 grid) as
2 x 2 (z, y) pencils.  tpumd runs ``run_segment(shard_carry(carry,
make_mesh(d)), ctx, 10)`` on d of the 8 virtual CPU devices of
tests/conftest.py, as tests/test_slab_halo.py does, d dividing the slot
count (8 for the 4^3 grid, 4 for the 3^3 grid's 1,404 slots).  x and v
by tag agree to 1e-10."""

import jax
import numpy as np
import pytest

from tpumd.md.verlet import run_segment
from tpumd.parallel.mesh import make_mesh, shard_carry
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import IN_LJ
from tpumd_torch.parallel.launch import run_decks, spawn_world

STEPS = 10
REBIN = "neigh_modify    delay 0 every 5 check no\n"


def _by_tag(tag, *arrays):
    tag = np.asarray(tag)
    keep = np.nonzero(tag > 0)[0]
    order = keep[np.argsort(tag[keep])]
    return [np.asarray(a)[order] for a in arrays]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("n, devices, layout", [(8, 8, (4, 1)),
                                                (6, 4, (2, 2))],
                         ids=["slabs", "pencils"])
def test_decomposed_port_equals_tpumd_sharded_run(tmp_path, n, devices,
                                                  layout):
    deck = IN_LJ.format(n=n) + REBIN
    script = JScript()
    script.run_string(deck)
    script._finalize_atoms()
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    sim.setup()
    assert sim._ctx.neigh_cfg.every == 5
    assert sim._carry[0].x.shape[0] % devices == 0
    out = run_segment(shard_carry(sim._carry, make_mesh(devices)), sim._ctx,
                      STEPS)
    assert len(out[0].x.sharding.device_set) == devices
    assert int(out[1].nbuilds) > int(sim._carry[1].nbuilds)
    jx, jv = _by_tag(out[0].tag, out[0].x, out[0].v)

    spec = {"setup": deck, "mode": "cellgrid", "runs": [f"run {STEPS}"]}
    ranks = spawn_world(run_decks, 4, "gloo", tmp_path / "pg", ([spec],),
                        timeout=240)
    for (r,) in ranks:
        assert (r["layout"]["pz"], r["layout"]["py"]) == layout
        assert sum(r["counts"]["build"]) >= 3
        np.testing.assert_allclose(r["x"], jx, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(r["v"], jv, rtol=1e-10, atol=1e-10)
