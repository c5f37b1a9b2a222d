"""The port's host fixes against tpumd and the reference binary, on the CPU
in f64.

* Each fix of md/fix_misc.py (setforce, addforce, spring/self, viscous,
  momentum, temp/rescale, temp/berendsen, press/berendsen, spring,
  efield, drag, recenter, aveforce, planeforce, lineforce, indent,
  enforce2d) and nve/limit and nve/noforce, their hooks applied once to
  one seeded 300-atom state through tpumd's class and the port's, on
  group all and where the fix takes one on a subgroup: positions,
  velocities, forces and the box to 1e-12 of their largest.
  spring/self's anchors reach the port through ``interop.with_fix_peratom``.
* tests/golden/fix_forces (spring tether, efield, recenter, aveforce,
  indent, planeforce, lineforce, velocity ramp) and tests/golden/press_ber
  (temp/berendsen with press/berendsen iso then aniso) verbatim on the
  cell grid against the reference binary's thermo.csv at tpumd's
  tolerances (tests/test_fix_forces.py, tests/test_press_ber.py; the
  first row of each step, which thermo takes from the force evaluation
  before press/berendsen's dilation).  The golden in f32 on the CPU: its
  gap to those rows, the base of the card's f32 gate on IN_PRESSBER32K.
* A 256-atom deck with nve, langevin, nvt, spring/self, addforce,
  viscous and momentum on two groups, 20 steps through tpumd and the
  port: every 5th step's thermo to 1e-10 relative.  spring/self tethers
  atoms of the box's interior, which cross no periodic face: tpumd's
  anchors are wrapped positions, the port's (as LAMMPS's) unwrapped.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.core.state import make_state as j_make_state
from tpumd.md import fix_misc as jm
from tpumd.md import fixes as jf
from tpumd.script.parser import LammpsScript as JScript
from tpumd.utils.units import get_units as j_units
from tpumd_torch import bench_targets as bt
from tpumd_torch.core.state import Box
from tpumd_torch.core.state import make_state as t_make_state
from tpumd_torch.interop import with_fix_peratom
from tpumd_torch.md import fix_misc as tm
from tpumd_torch.md import fixes as tf
from tpumd_torch.script.parser import LammpsScript as TScript
from tpumd_torch.utils.units import get_units as t_units

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
N = 300
MASS = np.array([1.0, 1.0, 2.5])
TDOF = 3.0 * N - 3.0


def _states(seed=11):
    """One seeded state in both packages: positions in a 6^3 box (some
    outside it, as between wraps), velocities, forces, charges, two types
    and group bits 2 and 4 on about half the atoms each."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.3, 6.3, (N, 3))
    v = rng.normal(scale=0.8, size=(N, 3))
    f = rng.normal(scale=3.0, size=(N, 3))
    q = rng.uniform(-1.0, 1.0, N)
    typ = rng.integers(1, 3, N)
    gm = 1 | (rng.integers(0, 2, N) * 2) | (rng.integers(0, 2, N) * 4)
    jbox = JBox.orthogonal(np.zeros(3), np.full(3, 6.0))
    js = j_make_state(x, v, typ, jbox, q=q).replace(
        f=jnp.asarray(f), gmask=jnp.asarray(gm, jnp.int32))
    tbox = Box.orthogonal(np.zeros(3), np.full(3, 6.0), device="cpu",
                          dtype=torch.float64)
    ts = t_make_state(x, v, typ, tbox, q=q, device="cpu",
                      dtype=torch.float64).replace(
        f=torch.as_tensor(f), gmask=torch.as_tensor(gm, dtype=torch.int32))
    return js, ts


def _ctx(mod):
    if mod is jnp:
        table = jnp.asarray(MASS)
        return types.SimpleNamespace(
            dt=0.005, units=j_units("lj"), tdof=TDOF,
            mass_per_atom=lambda s: table[s.type])
    table = torch.as_tensor(MASS)
    return types.SimpleNamespace(
        dt=0.005, units=t_units("lj"), tdof=TDOF,
        mass_per_atom=lambda s: table[s.type])


def _close(got, ref, tol=1e-12):
    ref = np.asarray(ref, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


# name: (constructor arguments, whether it takes a subgroup; group all
# only where tpumd acts on every atom whatever the group)
FIXES = {
    "setforce": ((0.25, None, -0.5), True),
    "addforce": ((0.1, -0.2, 0.3), True),
    "spring/self": ((7.5,), True),
    "viscous": ((0.4,), True),
    "momentum": ((4,), True),
    "temp/rescale": ((1, 0.5, 0.5, 0.05, 0.7), False),
    "temp/berendsen": ((0.7, 0.7, 0.4), False),
    "press/berendsen": (((True, False, True), (0.5, 0.0, 1.5),
                         (0.9, 0.0, 1.5), (1.0, 1.0, 2.0), 30.0, False),
                        False),
    "press/berendsen iso": (((True, True, True), (1.0,) * 3, (1.0,) * 3,
                             (5.0,) * 3, 10.0, True), False),
    "spring": ((10.0, 3.0, None, 2.5, 0.5), True),
    "efield": ((0.5, 0.2, -0.3), True),
    "drag": ((2.0, None, 3.0, 0.7, 1.5), True),
    "recenter": (("INIT", "NULL", 3.5), True),
    "aveforce": ((0.02, None, 0.01), True),
    "planeforce": ((1.0, 1.0, 0.0), True),
    "lineforce": ((0.0, 1.0, 2.0), True),
    "indent": ((10.0, 3.0, 3.0, 3.0, 2.0), True),
    "indent in": ((10.0, 3.0, 3.0, 3.0, 2.5, "in"), True),
    "enforce2d": ((), True),
    "nve/limit": ((0.01,), False),
    "nve/noforce": ((), False),
}
CLASSES = {"setforce": "FixSetForce", "addforce": "FixAddForce",
           "spring/self": "FixSpringSelf", "viscous": "FixViscous",
           "momentum": "FixMomentum", "temp/rescale": "FixTempRescale",
           "temp/berendsen": "FixTempBerendsen",
           "press/berendsen": "FixPressBerendsen", "spring": "FixSpring",
           "efield": "FixEfield", "drag": "FixDrag",
           "recenter": "FixRecenter", "aveforce": "FixAveForce",
           "planeforce": "FixPlaneForce", "lineforce": "FixLineForce",
           "indent": "FixIndent", "enforce2d": "FixEnforce2D",
           "nve/limit": "FixNVELimit", "nve/noforce": "FixNVENoforce"}
HOOKS = ("initial_integrate", "post_integrate", "post_force",
         "final_integrate", "end_of_step")


def _make(name, mod):
    args, _ = FIXES[name]
    cls = CLASSES[name.split()[0]]
    if name in ("nve/limit", "nve/noforce"):
        return getattr(jf if mod is jnp else tf, cls)(*args)
    if name.startswith("press/berendsen"):
        flags, start, stop, period, modulus, couple = args
        return getattr(jm if mod is jnp else tm, cls)(
            flags, start, stop, period, modulus=modulus, couple=couple)
    if name == "indent in":
        return getattr(jm if mod is jnp else tm, cls)(*args[:5],
                                                      side=args[5])
    return getattr(jm if mod is jnp else tm, cls)(*args)


def _run_hooks(fx, s, fs, ctx, mod):
    """Every hook once, in step order; the steps' inputs where asked."""
    if getattr(fx, "needs_step", False):
        fs = fx.set_step(fs, 40)
    if hasattr(fx, "pre_run"):
        fs = fx.pre_run(fs, 0, 100)
    if getattr(fx, "needs_virial", False):
        vir = [3.0, -1.5, 12.0, 0.5, 0.1, -0.2]
        fs = fx.save_virial(fs, jnp.asarray(vir) if mod is jnp
                            else torch.as_tensor(vir))
    for hook in HOOKS:
        s, fs = getattr(fx, hook)(s, fs, ctx)
    return s


@pytest.mark.parametrize("name", sorted(FIXES))
def test_fix_hooks_match_tpumd(name):
    jctx, tctx = _ctx(jnp), _ctx(torch)
    bits = (1, 4) if FIXES[name][1] else (1,)
    for bit in bits:
        js, ts = _states()
        jfx, tfx = _make(name, jnp), _make(name, torch)
        tfx.id = "t"
        jfx.groupbit = tfx.groupbit = bit
        jfs, tfs = jfx.init_state(js, jctx), tfx.init_state(ts, tctx)
        if name == "spring/self":
            # the anchors carried over as they are; the atoms then move
            ts = with_fix_peratom(ts, tfx, np.asarray(jfs))
        if name in ("spring/self", "recenter", "momentum"):
            shift = np.random.default_rng(3).normal(scale=0.1, size=(N, 3))
            js = js.replace(x=js.x + jnp.asarray(shift))
            ts = ts.replace(x=ts.x + torch.as_tensor(shift))
        jout = _run_hooks(jfx, js, jfs, jctx, jnp)
        tout = _run_hooks(tfx, ts, tfs, tctx, torch)
        for field in ("x", "v", "f"):
            _close(getattr(tout, field), getattr(jout, field))
        _close(tout.box.lo, jout.box.lo)
        _close(tout.box.hi, jout.box.hi)
        changed = sum(not np.array_equal(np.asarray(getattr(jout, k)),
                                         np.asarray(getattr(js, k)))
                      for k in ("x", "v", "f"))
        assert changed, f"fix {name} left the state as it was"


@pytest.mark.parametrize("name,ncol,atol", [("fix_forces", 5, 1e-9),
                                            ("press_ber", 6, 1e-8)])
def test_golden_verbatim(name, ncol, atol):
    d = os.path.join(GOLDEN, name)
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = d
    with open(os.path.join(d, "in.test")) as fh:
        t.run_string(fh.read())
    assert t.sim._ctx.is_cellgrid
    rows = bt.golden_rows(t.sim.log_lines, ncol)
    for ref in np.loadtxt(os.path.join(d, "thermo.csv")):
        step = int(ref[0])
        assert step in rows, f"missing thermo at step {step}"
        np.testing.assert_allclose(rows[step][1:], ref[1:], rtol=2e-6,
                                   atol=atol, err_msg=f"step {step}")


GROUP_DECK = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
region mid block 1 3 1 3 1 3
group core region mid
group rest subtract all core
velocity all create 1.2 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
neigh_modify every 1 delay 0 check yes
fix 1 rest nve
fix 2 rest langevin 1.0 1.0 1.0 48279
fix 3 core nvt temp 0.8 0.8 0.5
fix 4 core spring/self 5.0
fix 5 rest addforce 0.02 0.0 0.0
fix 6 core viscous 0.1
fix 7 all momentum 5 linear 1 1 1
thermo_style custom step temp epair etotal press
"""


def test_group_fixes_deck_against_tpumd():
    j = JScript()
    t = TScript(device="cpu", dtype=torch.float64)
    j.run_string(GROUP_DECK)
    t.run_string(GROUP_DECK)
    assert t.sim.fixes[1].rng == "lammps"
    for _ in range(4):
        j.run_string("run 5")
        t.run_string("run 5")
        jr, tr = j.sim.last_thermo, t.sim.last_thermo
        assert tr["step"] == jr["step"]
        for k in ("temp", "epair", "etotal", "press"):
            assert tr[k] == pytest.approx(jr[k], rel=1e-10, abs=1e-12), (
                k, tr["step"])


def test_press_ber_f32_gap():
    """The f32 run of the press_ber golden on the CPU: each column's gap to
    the reference binary's rows (``replicated_gaps``) within
    ``bench_targets.PRESSBER_F32_CPU_GAP``, the base of the card's f32 gate
    on the replicated deck."""
    d = os.path.join(GOLDEN, "press_ber")
    t = TScript(device="cpu", dtype=torch.float32)
    with open(os.path.join(d, "in.test")) as fh:
        t.run_string(fh.read())
    cols = t.sim.thermo_style[1:]
    rows = bt.golden_columns(t.sim.log_lines, cols)
    gaps = bt.replicated_gaps(rows, np.loadtxt(os.path.join(d, "thermo.csv")),
                              cols)
    print(f"press_ber f32 on the CPU: gaps {gaps}")
    for c, g in gaps.items():
        assert g <= bt.PRESSBER_F32_CPU_GAP[c], (c, g)
