"""Every bonded style of tpumd against the port's, one case each (53): the
same seeded chain of atoms, the same coefficients for two types (random
in each style's valid range), and the same tuples (bonds, angles,
dihedrals and impropers of consecutive chain atoms, their types drawn at
random) through tpumd's style (f64, its tuple function per tuple) and the
port's (``compute_tuples`` over the style's parts).  The per-atom forces,
each energy and the virial agree to 1e-12 relative, and the port's
per-atom tallies (``compute_tuples_peratom``) sum to its totals.  Each
hybrid runs two sub-styles, one a type; bond quartic takes lj/cut's
single and dihedral charmm lj/charmm/coul/charmm's 1-4 tables."""

import os
import zlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.core.state import Box as JBox
from tpumd.models.registry import create_bonded_style as j_create
from tpumd.models.registry import create_pair_style as j_pair
from tpumd.ops.pairwise import minimum_image as j_mi
from tpumd.utils.units import get_units as j_units
from tpumd_torch.core.state import Box
from tpumd_torch.models import bonded as tb
from tpumd_torch.models.registry import create_bonded_style as t_create
from tpumd_torch.models.registry import create_pair_style as t_pair
from tpumd_torch.utils.units import get_units as t_units

TABLES = os.path.join(os.path.dirname(__file__), "golden", "bonded_table")
ARITY = {"bond": 2, "angle": 3, "dihedral": 4, "improper": 4}
NATOMS = 160
L = 60.0


def u(rng, lo, hi):
    return float(rng.uniform(lo, hi))


# (kind, name): (style arguments, rng -> [coeff lines of type 1],
# rng -> [coeff lines of type 2]); a coeff line is its arguments after the
# type.  A hybrid's lines start with the sub-style.
def _same(f):
    return (f, f)


STYLES = {
    # ------------------------------------------------------------ bonds
    ("bond", "harmonic"): ((), *_same(lambda r: [[u(r, 100, 400),
                                                  u(r, 1.0, 1.3)]])),
    ("bond", "fene"): ((), *_same(lambda r: [[u(r, 20, 40), u(r, 1.4, 1.6),
                                              1.0, u(r, 0.9, 1.0)]])),
    ("bond", "morse"): ((), *_same(lambda r: [[u(r, 50, 150),
                                               u(r, 1.5, 2.5),
                                               u(r, 1.0, 1.2)]])),
    ("bond", "gromos"): ((), *_same(lambda r: [[u(r, 100, 300),
                                                u(r, 1.0, 1.2)]])),
    ("bond", "fene/expand"): ((), *_same(lambda r: [[
        u(r, 20, 40), u(r, 1.4, 1.6), 1.0, u(r, 0.8, 0.9),
        u(r, 0.02, 0.1)]])),
    ("bond", "zero"): ((), *_same(lambda r: [[u(r, 1.0, 1.2)]])),
    ("bond", "nonlinear"): ((), *_same(lambda r: [[
        u(r, 20, 40), u(r, 1.0, 1.1), u(r, 1.6, 1.9)]])),
    ("bond", "quartic"): ((), *_same(lambda r: [[
        u(r, 1000, 1300), -0.55, 0.25, u(r, 1.25, 1.35),
        u(r, 30, 40)]])),
    ("bond", "hybrid"): (("harmonic", "morse"),
                         lambda r: [["harmonic", u(r, 100, 400),
                                     u(r, 1.0, 1.3)]],
                         lambda r: [["morse", u(r, 50, 150), u(r, 1.5, 2.5),
                                     u(r, 1.0, 1.2)]]),
    ("bond", "table"): (("spline", 800), *_same(lambda r: [[
        os.path.join(TABLES, "bond.table"), "BOND_MORSE"]])),
    ("bond", "class2"): ((), *_same(lambda r: [[
        u(r, 1.0, 1.2), u(r, 200, 400), u(r, -600, -400),
        u(r, 600, 800)]])),
    ("bond", "fene/nm"): ((), *_same(lambda r: [[
        u(r, 20, 25), u(r, 1.7, 1.9), u(r, 0.5, 0.7), u(r, 1.0, 1.2), 6.0,
        4.0]])),
    ("bond", "gaussian"): ((), *_same(lambda r: [[
        300.0, 2, u(r, 0.5, 0.7), 0.25, u(r, 1.0, 1.1), 0.4, 0.32,
        u(r, 1.3, 1.4)]])),
    ("bond", "harmonic/shift"): ((), *_same(lambda r: [[
        u(r, 10, 14), u(r, 1.1, 1.2), u(r, 1.8, 2.0)]])),
    ("bond", "harmonic/shift/cut"): ((), *_same(lambda r: [[
        u(r, 10, 14), u(r, 1.0, 1.1), u(r, 1.15, 1.2)]])),
    # ----------------------------------------------------------- angles
    ("angle", "harmonic"): ((), *_same(lambda r: [[u(r, 30, 80),
                                                   u(r, 100, 120)]])),
    ("angle", "charmm"): ((), *_same(lambda r: [[
        u(r, 30, 80), u(r, 100, 120), u(r, 5, 20), u(r, 1.6, 2.0)]])),
    ("angle", "cosine/squared"): ((), *_same(lambda r: [[
        u(r, 30, 80), u(r, 100, 120)]])),
    ("angle", "zero"): ((), *_same(lambda r: [[u(r, 100, 120)]])),
    ("angle", "cosine"): ((), *_same(lambda r: [[u(r, 20, 40)]])),
    ("angle", "cosine/periodic"): ((), lambda r: [[u(r, 30, 50), -1, 3]],
                                   lambda r: [[u(r, 30, 50), 1, 2]]),
    ("angle", "quartic"): ((), *_same(lambda r: [[
        u(r, 100, 120), u(r, 20, 30), u(r, -15, -10), u(r, 5, 8)]])),
    ("angle", "hybrid"): (("harmonic", "cosine/squared"),
                          lambda r: [["harmonic", u(r, 30, 80),
                                      u(r, 100, 120)]],
                          lambda r: [["cosine/squared", u(r, 30, 80),
                                      u(r, 100, 120)]]),
    ("angle", "table"): (("linear", 600), *_same(lambda r: [[
        os.path.join(TABLES, "angle.table"), "ANG_QC"]])),
    ("angle", "class2"): ((), *_same(lambda r: [
        [u(r, 100, 120), u(r, 40, 60), u(r, -12, -8), u(r, 4, 6)],
        ["bb", u(r, 15, 25), u(r, 1.0, 1.2), u(r, 1.0, 1.2)],
        ["ba", u(r, 10, 20), u(r, 5, 15), u(r, 1.0, 1.2),
         u(r, 1.0, 1.2)]])),
    ("angle", "cosine/delta"): ((), *_same(lambda r: [[u(r, 20, 40),
                                                       u(r, 100, 120)]])),
    ("angle", "cosine/shift"): ((), *_same(lambda r: [[u(r, 20, 40),
                                                       u(r, 100, 120)]])),
    ("angle", "cosine/shift/exp"): (
        (), lambda r: [[u(r, 20, 30), u(r, 100, 120), u(r, 2, 3)]],
        lambda r: [[u(r, 20, 30), u(r, 100, 120), 0.0005]]),
    ("angle", "fourier"): ((), *_same(lambda r: [[
        u(r, 15, 25), u(r, 0.1, 0.3), u(r, 0.3, 0.5), u(r, 0.3, 0.5)]])),
    ("angle", "fourier/simple"): ((), *_same(lambda r: [[
        u(r, 20, 30), u(r, -0.6, -0.4), 2.0]])),
    ("angle", "gaussian"): ((), *_same(lambda r: [[
        300.0, 2, u(r, 1.0, 1.4), 15.0, u(r, 95, 105), 0.8, 20.0,
        u(r, 120, 130)]])),
    # -------------------------------------------------------- dihedrals
    ("dihedral", "harmonic"): ((), lambda r: [[u(r, 1, 3), 1, 3]],
                               lambda r: [[u(r, 1, 3), -1, 2]]),
    ("dihedral", "charmm"): ((), lambda r: [[u(r, 1, 3), 3, 0, 0.5]],
                             lambda r: [[u(r, 1, 3), 2, 180, 1.0]]),
    ("dihedral", "opls"): ((), *_same(lambda r: [[
        u(r, 1, 2), u(r, 0.5, 1), u(r, -0.6, -0.4), u(r, 0.2, 0.4)]])),
    ("dihedral", "multi/harmonic"): ((), *_same(lambda r: [[
        u(r, 1, 1.5), u(r, 0.6, 1), u(r, -0.8, -0.4), u(r, 0.2, 0.6),
        u(r, -0.3, -0.1)]])),
    ("dihedral", "zero"): ((), *_same(lambda r: [[]])),
    ("dihedral", "hybrid"): (("opls", "multi/harmonic"),
                             lambda r: [["opls", u(r, 1, 2), 0.8, -0.5,
                                         0.3]],
                             lambda r: [["multi/harmonic", 1.2, 0.8, -0.6,
                                         0.4, u(r, -0.3, -0.1)]]),
    ("dihedral", "class2"): ((), *_same(lambda r: [
        [u(r, 7, 9), 173.0, u(r, 4, 6), 60.0, u(r, 2, 3), 30.0],
        ["mbt", u(r, 1, 1.4), -0.8, 0.5, u(r, 1.0, 1.2)],
        ["ebt", 0.3, 0.4, -0.2, 0.1, -0.3, 0.5, u(r, 1.0, 1.2),
         u(r, 1.0, 1.2)],
        ["at", 0.9, -0.6, 0.3, 0.2, 0.5, -0.4, u(r, 100, 120),
         u(r, 100, 120)],
        ["aat", u(r, -6, -4), u(r, 100, 120), u(r, 100, 120)],
        ["bb13", u(r, 2, 4), u(r, 1.0, 1.2), u(r, 1.0, 1.2)]])),
    ("dihedral", "fourier"): ((), lambda r: [[3, u(r, 1, 2), 1, 0.0, 0.8,
                                              2, 90.0, 0.4, 3, 30.0]],
                              lambda r: [[1, u(r, 1, 2), 2, 45.0]]),
    ("dihedral", "helix"): ((), *_same(lambda r: [[
        u(r, 1, 1.5), u(r, 0.7, 1), u(r, 0.5, 0.8)]])),
    ("dihedral", "nharmonic"): ((), lambda r: [[4, 1.0, u(r, -0.8, -0.6),
                                                0.5, 0.3]],
                                lambda r: [[2, u(r, 0.5, 1), 0.2]]),
    ("dihedral", "quadratic"): ((), *_same(lambda r: [[u(r, 4, 8),
                                                       u(r, 50, 80)]])),
    ("dihedral", "cosine/shift/exp"): (
        (), lambda r: [[u(r, 4, 6), u(r, 60, 80), u(r, 2, 4)]],
        lambda r: [[u(r, 4, 6), u(r, 60, 80), 0.0005]]),
    # -------------------------------------------------------- impropers
    ("improper", "harmonic"): ((), *_same(lambda r: [[u(r, 5, 10),
                                                      u(r, 0, 20)]])),
    ("improper", "cvff"): ((), lambda r: [[u(r, 5, 10), -1, 2]],
                           lambda r: [[u(r, 5, 10), 1, 3]]),
    ("improper", "umbrella"): ((), lambda r: [[u(r, 5, 10), 0.0]],
                               lambda r: [[u(r, 5, 10), u(r, 10, 20)]]),
    ("improper", "zero"): ((), *_same(lambda r: [[]])),
    ("improper", "hybrid"): (("harmonic", "cvff"),
                             lambda r: [["harmonic", u(r, 5, 10), 0.0]],
                             lambda r: [["cvff", u(r, 5, 10), -1, 2]]),
    ("improper", "class2"): ((), *_same(lambda r: [
        [u(r, 20, 30), u(r, 0, 10)],
        ["aa", u(r, 3, 5), u(r, -4, -2), u(r, 1, 3), u(r, 100, 120),
         u(r, 100, 120), u(r, 100, 120)]])),
    ("improper", "cossq"): ((), *_same(lambda r: [[u(r, 5, 10),
                                                   u(r, 10, 30)]])),
    ("improper", "fourier"): ((), lambda r: [[u(r, 5, 8), 0.3, 0.5, 0.2,
                                              1]],
                              lambda r: [[u(r, 5, 8), 0.2, 0.4, 0.3, 0]]),
    ("improper", "ring"): ((), *_same(lambda r: [[u(r, 5, 10),
                                                  u(r, 60, 90)]])),
    ("improper", "distance"): ((), *_same(lambda r: [[u(r, 30, 50),
                                                      u(r, 10, 20)]])),
}


def chain(seed):
    """A random walk of NATOMS atoms, steps 0.95-1.2 long, in an L box
    (periodic; the walk crosses its faces), with types 1/2 and charges."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(NATOMS, 3))
    d *= (rng.uniform(0.95, 1.2, NATOMS) / np.linalg.norm(d, axis=1))[:, None]
    x = np.mod(np.cumsum(d, axis=0) + L - 3.0, L)
    return x, rng.integers(1, 3, NATOMS), rng.uniform(-0.5, 0.5, NATOMS)


def tuples_of(kind, rng):
    """Consecutive-atom tuples, every one of the chain, types at random:
    (M, 1 + arity), members as 0-based rows."""
    a = ARITY[kind]
    m = NATOMS - a + 1
    t = np.zeros((m, 1 + a), np.int64)
    t[:, 0] = rng.integers(1, 3, m)
    for k in range(a):
        t[:, 1 + k] = np.arange(m) + k
    return t


def make(create, kind, name, args, lines, pair, units):
    style = create(kind, name, args, 2) if create is t_create else \
        create(kind, name, 2, args)
    for ttype, coeffs in ((1, lines[0]), (2, lines[1])):
        for line in coeffs:
            style.coeff(ttype, *line)
    style.units = units
    style.init()
    return style


def pairs_of(name):
    """(tpumd pair, port pair): lj/cut for quartic, lj/charmm/coul/charmm
    (its 1-4 tables) for dihedral charmm."""
    if name == "quartic":
        jp, tp = j_pair("lj/cut", 2, [2.5]), t_pair("lj/cut", 2, [2.5])
        for p in (jp, tp):
            p.coeff(1, 1, 1, 1, 1.0, 1.0)
            p.coeff(2, 2, 2, 2, 0.8, 1.1)
    else:
        jp = j_pair("lj/charmm/coul/charmm", 2, [7.0, 8.0])
        tp = t_pair("lj/charmm/coul/charmm", 2, [7.0, 8.0])
        for p in (jp, tp):
            p.coeff(1, 1, 1, 1, 0.1, 3.2, 0.05, 3.0)
            p.coeff(2, 2, 2, 2, 0.2, 2.8)
    jp.init()
    tp.init()
    return jp, tp


def tpumd_totals(style, kind, x, q, types, t, ctx):
    """(f (N, 3), {key: energy}, virial (6,)) of tpumd's style, each
    tuple evaluated once: its bond function or its tuple function on
    (M, 1) rows."""
    box = JBox.orthogonal(np.zeros(3), np.full(3, L), dtype=jnp.float64)
    a = ARITY[kind]
    f = np.zeros_like(x)
    mem = [t[:, 1 + k] for k in range(a)]
    ttype = jnp.asarray(t[:, 0])
    if a == 2 and not hasattr(style, "tuple_terms"):
        d = j_mi(jnp.asarray(x[mem[0]] - x[mem[1]]), box)
        r2 = jnp.sum(d * d, -1)
        e = {}
        if style.name == "quartic":
            fb, eb, esub = style._terms(None, r2, d, ttype, ctx,
                                        (jnp.asarray(types[mem[0]]),
                                         jnp.asarray(types[mem[1]])))
            e["evdwl"] = -float(jnp.sum(esub))
        else:
            fb, eb = style.bond_fn(r2, ttype)
        e["ebond"] = float(jnp.sum(eb))
        d, fb = np.asarray(d), np.asarray(fb)
        f1 = fb[:, None] * d
        np.add.at(f, mem[0], f1)
        np.add.at(f, mem[1], -f1)
        w = np.einsum("mi,mj->ij", d, f1)
        return f, e, w[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]]
    xs = [jnp.asarray(x[m][:, None, :]) for m in mem]
    s = SimpleNamespace(type=jnp.asarray(types), q=jnp.asarray(q))
    flist, ed, vp, extra = style.tuple_terms(
        xs, ttype[:, None], box, ctx, True, True, s=s,
        idx=jnp.asarray(np.stack(mem, 1)[:, None, :]),
        mask=jnp.ones((len(t), 1), bool),
        role=jnp.zeros((len(t), 1), jnp.int8))
    for m, fm in zip(mem, flist):
        np.add.at(f, m, np.asarray(fm)[:, 0])
    e = {k: float(jnp.sum(v)) for k, v in ed.items()}
    w = np.zeros((3, 3))
    for r, fv in vp:
        w += np.einsum("mpi,mpj->ij", np.asarray(r), np.asarray(fv))
    vir = w[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]]
    if extra is not None:
        # dihedral charmm's 1-4 pair: member 1's force per row (role 0),
        # with 1/arity tallies of a tuple seen once here
        fx, ex, vx = extra
        np.add.at(f, mem[0], np.asarray(fx))
        np.add.at(f, mem[3], -np.asarray(fx))
        for k, v in ex.items():
            e[k] = 4.0 * float(v)
        vir = vir + 4.0 * np.asarray(vx)
    return f, e, vir


@pytest.mark.parametrize("kind,name", sorted(STYLES))
def test_bonded_style_against_tpumd(kind, name):
    args, l1, l2 = STYLES[(kind, name)]
    rng = np.random.default_rng(zlib.crc32(f"{kind} {name}".encode()))
    seed = int(rng.integers(1 << 30))
    lines = (l1(np.random.default_rng(seed)),
             l2(np.random.default_rng(seed + 1)))
    x, types, q = chain(seed)
    t = tuples_of(kind, rng)
    jp = tp = None
    if name in ("quartic", "charmm") and kind in ("bond", "dihedral"):
        jp, tp = pairs_of(name)
    jstyle = make(j_create, kind, name, args, lines, jp, j_units("real"))
    tstyle = make(t_create, kind, name, args, lines, tp, t_units("real"))
    jf, je, jv = tpumd_totals(jstyle, kind, x, q, types, t,
                              SimpleNamespace(pair=jp,
                                              units=j_units("real")))

    tctx = SimpleNamespace(pair=tp, units=t_units("real"))
    view = (torch.as_tensor(x), torch.as_tensor(types, dtype=torch.int32),
            torch.as_tensor(q))
    box = Box.orthogonal(np.zeros(3), np.full(3, L), device="cpu",
                         dtype=torch.float64)
    tf = torch.zeros_like(view[0])
    te, tv = {}, torch.zeros(6, dtype=torch.float64)
    eatom, vatom = torch.zeros(NATOMS, dtype=torch.float64), 0.0
    parts = tstyle.parts(t)
    if kind != "bond" and name == "hybrid":
        assert [len(p) for _, p in parts] == [int((t[:, 0] == k).sum())
                                              for k in (1, 2)]
    for sub, part in parts:
        f_, e_, v_ = tb.compute_tuples(sub, view, torch.as_tensor(part),
                                       box, tctx, True, True)
        tf += f_
        tv += v_
        for k, v in e_.items():
            te[k] = te.get(k, 0.0) + float(v)
        ea, va = tb.compute_tuples_peratom(sub, view, torch.as_tensor(part),
                                           box, tctx)
        eatom += ea
        vatom = vatom + va

    fmax = max(np.abs(jf).max(), 1e-300)
    if name != "zero":
        assert fmax > 1e-3, "the inputs load the style"
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-12 * fmax)
    assert {k for k, v in te.items() if v != 0.0} == {
        k for k, v in je.items() if v != 0.0}
    escale = max(abs(v) for v in list(je.values()) + [1.0])
    for k in je:
        assert te.get(k, 0.0) == pytest.approx(je[k], rel=1e-12,
                                               abs=1e-12 * escale), k
    vscale = max(np.abs(jv).max(), 1e-300)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-12 * vscale)
    # the per-atom tallies sum to the totals
    assert float(eatom.sum()) == pytest.approx(sum(te.values()), rel=1e-12,
                                               abs=1e-12 * escale)
    np.testing.assert_allclose(vatom.sum(0).numpy(), tv.numpy(), rtol=0,
                               atol=1e-12 * vscale)
