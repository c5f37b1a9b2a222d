"""A crowded fix pour against tpumd: an insertion that runs out of attempts.

The port's fix pour draws its attempts in batches, tests each batch
against the near atoms at once, and puts the RanPark stream back to just
after the point taken.  In tests/golden/gran/in.pour every attempt finds
room; here most fail, so the stream is put back after nearly every
sphere.  The inserted spheres (count, positions, velocities, radii,
masses by tag) and the stream's state after the insertion equal tpumd's
attempt-by-attempt loop bit for bit.  pour20k's stored atom counts
(bench_targets.POUR20K_ATOMS) come from the port and rest on this
equality: tpumd's loop would take hours at that size.
"""

import numpy as np
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.md.fix_pour import FixPour
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)


def _by_tag(s, keys=("x", "v", "radius", "rmass")):
    tag = np.asarray(s.tag if not isinstance(s.tag, torch.Tensor)
                     else s.tag.numpy())
    live = tag > 0
    order = np.argsort(tag[live])
    out = {"tag": tag[live][order]}
    for k in keys:
        a = getattr(s, k)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out[k] = a[live][order]
    return out


# A crowded insertion: fix pour 5000 into a cylinder of radius 5 and height
# 6 over a floor layer just below it (its spheres in the overlap test).
# fix pour draws each sphere's height first, biased to the top, so the top
# fills and most attempts fail; the 145th sphere finds no room in the
# attempts left of the 224 x 50 and the insertion stops at 144.
CROWDED = """
units           lj
atom_style      sphere
boundary        p p fm
region          box block -9 9 -9 9 0 10
create_box      1 box
lattice         sc 1.0
region          floor block -7 6.5 -7 6.5 0.9 1.1 units box
create_atoms    1 region floor
pair_style      gran/hooke/history 2000.0 NULL 50.0 NULL 0.5 1
pair_coeff      * *
region          ins cylinder z 0 0 5 2 8 units box
fix             g all gravity 1.0 vector 0 0 -1
fix             i all nve/sphere
fix             p all pour 5000 1 4767548 region ins diam one 1.0
neighbor        0.3 bin
neigh_modify    delay 0 every 1
timestep        0.001
thermo          1
run             0
"""


def test_crowded_pour_that_runs_out_of_attempts_equals_tpumd():
    """The port draws its attempts in batches and puts the random stream
    back to the point taken; where most of ~11,000 attempts fail, its
    insertion still equals tpumd's attempt-by-attempt loop bit for bit:
    the same 144 spheres, positions, velocities, radii and masses."""
    j = JScript()
    j.run_string(CROWDED)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(CROWDED)
    fx = [f for f in t.sim.fixes if isinstance(f, FixPour)][0]
    assert fx.nper == 224
    a, b = _by_tag(t.sim.state), _by_tag(j.sim.state)
    assert len(a["tag"]) == len(b["tag"]) == 196 + 144
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert fx.rng.seed == [f for f in j.sim.fixes
                           if type(f).__name__ == "FixPour"][0].rng.seed
    ins = [ln for ln in t.sim.log_lines if "inserted" in ln]
    assert ins == [ln for ln in j.sim.log_lines if "inserted" in ln]
    assert ins == ["fix pour: inserted 144 atoms (144/5000)"]
