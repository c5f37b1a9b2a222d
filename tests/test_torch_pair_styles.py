"""The pairwise style library and lj/charmm/coul/long on the matrix
engine: the port against tpumd on the CPU in float64.

Each case builds one style through both packages' registries from the same
``pair_style`` and ``pair_coeff`` lines, on a 256-atom fcc deck of two
atom types carrying +-0.5 charges whose positions ``displace_atoms
random`` moves off the lattice (``kspace_style pppm`` beside the coul/long
styles, so g_ewald is set), then

* compares the styles' pair functions (``pair_fn`` or ``pair_fn_ex``; a
  hybrid's, each sub-style's masked to its type pairs) on seeded numpy
  squared distances, types and charges, and special weights for
  ``pair_fn_ex``;
* compares one step-0 force evaluation (``run 0``): forces in tag order,
  evdwl, ecoul and elong, and the pressure;

each to 1e-12 relative (forces relative to the largest).  The styles with
a Coulomb self-energy (Wolf, DSF) add it to ecoul in both.  tpumd's hybrid
styles take no kspace (no ``cut_coul``), so the hybrid cases here carry
none; tests/test_torch_kspace_matrix.py holds a hybrid with a coul/long
sub-style under PPPM to the single style it spells out.
"""

import os

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                     "pair_table", "lj.table")

DECK = """
units lj
atom_style charge
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 2 box
create_atoms 1 box
region left block 0 2 0 4 0 4
set region left type 2
set type 1 charge 0.5
set type 2 charge -0.5
mass 1 1.0
mass 2 1.3
displace_atoms all random 0.06 0.06 0.06 4711
velocity all create 1.44 87287 loop geom
pair_style {ps}
{coeffs}
{kspace}neighbor 0.3 bin
neigh_modify delay 0 every 5 check no
fix 1 all nve
"""

PPPM = "kspace_style pppm 1e-5\n"


def two(c1, c2):
    """pair_coeff lines for the two like pairs (the 1-2 pair mixes)."""
    return f"pair_coeff 1 1 {c1}\npair_coeff 2 2 {c2}"


# name -> (pair_style arguments, pair_coeff lines, kspace line)
CASES = {
    "born": ("born 2.5", two("1.0 0.5 1.2 1.0 0.5", "0.8 0.4 1.0 0.9 0.4"),
             ""),
    "buck": ("buck 2.5", two("1000.0 0.3 1.5", "800.0 0.32 1.2"), ""),
    "coul/cut": ("coul/cut 2.5", "pair_coeff * *", ""),
    "coul/debye": ("coul/debye 1.4 2.5", "pair_coeff * *", ""),
    "gauss": ("gauss 2.5", two("1.0 0.8", "0.7 1.1"), ""),
    "lj/cut/coul/cut": ("lj/cut/coul/cut 2.5 2.2",
                        two("1.0 1.0", "0.8 1.1"), ""),
    "lj/cut/coul/long": ("lj/cut/coul/long 2.5", two("1.0 1.0", "0.8 1.1"),
                         PPPM),
    "lj/expand": ("lj/expand 2.0", two("1.0 0.8 0.3", "0.9 0.85 0.2"), ""),
    "morse": ("morse 2.5", two("0.5 1.3 1.1 2.5", "0.4 1.2 1.05"), ""),
    "soft": ("soft 2.5", two("1.0", "1.5 2.2"), ""),
    "yukawa": ("yukawa 1.2 2.5", two("2.0", "1.5"), ""),
    "zero": ("zero 2.5", "pair_coeff * *", ""),
    "coul/long": ("coul/long 2.5", "pair_coeff * *", PPPM),
    "coul/dsf": ("coul/dsf 0.8 2.5", "pair_coeff * *", ""),
    "coul/wolf": ("coul/wolf 0.8 2.5", "pair_coeff * *", ""),
    "zbl": ("zbl 1.5 2.0", "pair_coeff 1 1 29 29\npair_coeff 1 2 29 14\n"
            "pair_coeff 2 2 14 14", ""),
    "buck/coul/cut": ("buck/coul/cut 2.5 2.2",
                      two("100.0 0.5 1.0", "90.0 0.45 1.2"), ""),
    "buck/coul/long": ("buck/coul/long 2.5",
                       two("100.0 0.5 1.0", "90.0 0.45 1.2"), PPPM),
    "born/coul/long": ("born/coul/long 2.5",
                       two("10.0 0.4 1.0 1.0 0.5", "8.0 0.35 1.1 0.9 0.4"),
                       PPPM),
    "born/coul/wolf": ("born/coul/wolf 0.5 2.4 2.5",
                       two("1.5 0.4 1.2 1.0 0.5", "1.2 0.35 1.1 0.9 0.4"),
                       ""),
    "born/coul/dsf": ("born/coul/dsf 0.5 2.4 2.5",
                      two("1.5 0.4 1.2 1.0 0.5", "1.2 0.35 1.1 0.9 0.4"),
                      ""),
    "lj/class2": ("lj/class2 2.5", two("1.0 1.0", "0.8 1.1"), ""),
    "lj/class2/coul/cut": ("lj/class2/coul/cut 2.5",
                           two("1.0 1.0", "0.8 1.1"), ""),
    "lj/class2/coul/long": ("lj/class2/coul/long 2.5",
                            two("1.0 1.0", "0.8 1.1"), PPPM),
    "nm/cut": ("nm/cut 2.5", two("1.0 1.12 10 5", "0.8 1.1 12 6"), ""),
    "mie/cut": ("mie/cut 2.5", two("1.0 1.0 14 7", "0.8 1.05 12 6"), ""),
    "lj/gromacs": ("lj/gromacs 2.0 2.5", two("1.0 1.0", "0.8 1.1"), ""),
    "lj/smooth/linear": ("lj/smooth/linear 2.5", two("1.0 1.0", "0.8 1.1"),
                         ""),
    "harmonic/cut": ("harmonic/cut", two("2.0 1.5", "1.5 1.3"), ""),
    "lj/cut/coul/wolf": ("lj/cut/coul/wolf 0.5 2.4 2.5",
                         two("1.0 1.0", "0.8 1.1"), ""),
    "lj/cut/coul/dsf": ("lj/cut/coul/dsf 0.5 2.4 2.5",
                        two("1.0 1.0", "0.8 1.1"), ""),
    "table linear": ("table linear 1000", f"pair_coeff * * {TABLE} LJTAB",
                     ""),
    "table lookup": ("table lookup 1500", f"pair_coeff * * {TABLE} LJTAB",
                     ""),
    "table spline": ("table spline 800", f"pair_coeff * * {TABLE} LJTAB",
                     ""),
    "hybrid": ("hybrid lj/cut 2.5 morse 2.5",
               "pair_coeff 1 1 lj/cut 1.0 1.0 2.5\n"
               "pair_coeff 2 2 lj/cut 0.8 1.05 2.5\n"
               "pair_coeff 1 2 morse 0.2 2.0 1.1", ""),
    "hybrid/overlay": ("hybrid/overlay lj/cut 2.5 coul/dsf 0.8 2.5",
                       "pair_coeff * * lj/cut 1.0 1.0 2.5\n"
                       "pair_coeff * * coul/dsf", ""),
    "hybrid/scaled": ("hybrid/scaled 0.7 lj/cut 2.5 0.5 coul/wolf 0.8 2.5",
                      "pair_coeff * * lj/cut 1.0 1.0 2.5\n"
                      "pair_coeff * * coul/wolf", ""),
    "lj/charmm/coul/charmm": ("lj/charmm/coul/charmm 2.0 2.5 1.8 2.4",
                              two("1.0 1.0", "0.8 1.1"), ""),
    "lj/charmm/coul/long": ("lj/charmm/coul/long 2.0 2.5",
                            two("1.0 1.0", "0.8 1.1"), PPPM),
}


def run_both(name):
    ps, coeffs, kspace = CASES[name]
    deck = DECK.format(ps=ps, coeffs=coeffs, kspace=kspace)
    js = JScript()
    ts = TScript(device="cpu", dtype=torch.float64)
    for script in (js, ts):
        script.run_string(deck)
        script.sim.neighbor_mode = "matrix"
        script.run_string("run 0")
    return js.sim, ts.sim


def pair_functions(jpair, tpair):
    """[(tpumd's, the port's, takes specials)] pair functions of a style;
    for a hybrid, each sub-style's masked one."""
    if hasattr(tpair, "subs"):
        out = []
        for jm, tm in zip(jpair.subs, tpair.subs):
            jfn, jex = jm.wrap_pair_fn()
            tfn, tex = tm.pair_fns()
            out.append((jex, tex, True) if tex is not None
                       else (jfn, tfn, False))
        return out
    tex = getattr(tpair, "pair_fn_ex", None)
    if tex is not None:
        return [(jpair.pair_fn_ex, tex, True)]
    return [(jpair.pair_fn, tpair.pair_fn, False)]


def close(a, b, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    return a.shape == b.shape and float(np.abs(a - b).max()) <= rel * scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_style_against_tpumd(name):
    import jax.numpy as jnp
    jsim, tsim = run_both(name)
    tpair = tsim.pair
    assert tsim._mode == "matrix" and not tsim._ctx.is_cellgrid
    # the pair functions on seeded pairs
    rng = np.random.default_rng(2026)
    m, k = 64, 48
    r2 = rng.uniform(0.55 ** 2, (1.15 * tpair.max_cutoff) ** 2, (m, k))
    it = rng.integers(1, 3, (m, 1)).astype(np.int32)
    jt = rng.integers(1, 3, (m, k)).astype(np.int32)
    qi = rng.uniform(-1.0, 1.0, (m, 1))
    qj = rng.uniform(-1.0, 1.0, (m, k))
    w_lj = rng.choice([1.0, 0.0, 0.5], (m, k))
    w_c = rng.choice([1.0, 0.0, 0.8333], (m, k))
    for jfn, tfn, ex in pair_functions(jsim.pair, tpair):
        jargs = [jnp.asarray(a) for a in (r2, it, jt)]
        targs = [torch.as_tensor(a) for a in (r2, it, jt)]
        if ex:
            jargs += [jnp.asarray(a) for a in (w_lj, w_c, qi, qj)]
            targs += [torch.as_tensor(a) for a in (w_lj, w_c, qi, qj)]
        jout, tout = jfn(*jargs), tfn(*targs)
        for a, b in zip(tout, jout):
            assert (a is None) == (b is None) or (
                b is None and float(torch.abs(a).max()) == 0.0)
            if a is not None and b is not None:
                assert close(a.numpy(), b), f"{name}: pair function"
    # one step-0 force evaluation
    jtag = np.asarray(jsim.state.tag)
    ttag = tsim.state.tag.numpy()
    jf = np.asarray(jsim.state.f)[np.argsort(jtag)]
    tf = tsim.state.f.numpy()[np.argsort(ttag)]
    assert (float(np.abs(tf).max()) > 0.0) == (name != "zero")
    assert close(tf, jf), f"{name}: step-0 forces"
    jv, tv = jsim.last_thermo, tsim.last_thermo
    for key in ("evdwl", "ecoul", "elong", "epair", "press"):
        assert abs(tv[key] - jv[key]) <= 1e-12 * max(abs(jv[key]), 1e-12), \
            (name, key, tv[key], jv[key])


def test_self_energy_in_pe_atom():
    """LAMMPS tallies the Wolf/DSF self-energy into eatom[i]
    (ev_tally(i, i, ...), src/pair_coul_dsf.cpp:37), so the sum of
    pe/atom is pe; the port follows it.  tpumd's per-atom path runs the
    pair sums alone (tpumd/models/base.py:78-87): its sum misses pe by the
    self-energy (ROADMAP C17, pinned here)."""
    from tpumd.md import peratom as jpa
    from tpumd_torch.md import peratom as tpa
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "wolfdsf")
    deck = open(os.path.join(gold, "in.ljdsf")).read().replace(
        "run             100", "")
    js, ts = JScript(data_dir=gold), TScript(device="cpu",
                                             dtype=torch.float64)
    ts.data_dir = gold
    for script in (js, ts):
        script.run_string(deck)
        script.sim.neighbor_mode = "matrix"
        script.run_string("run 0")
    n = ts.sim.natoms
    pe = ts.sim.last_thermo["pe"] * n
    assert js.sim.last_thermo["pe"] * n == pytest.approx(pe, rel=1e-12)
    eatom, _ = tpa.pair_bonded_tallies(ts.sim)
    assert float(eatom.sum()) == pytest.approx(pe, rel=1e-12)
    self_e = float(ts.sim.pair.ecoul_self_atom(ts.sim.state.q).sum())
    assert self_e < -1.0
    j_eatom, _ = jpa.pair_bonded_tallies(js.sim)
    assert float(np.sum(j_eatom)) == pytest.approx(pe - self_e, rel=1e-12)
    # the rest of each atom's tally is tpumd's
    q = ts.sim.state.q
    own = (eatom - ts.sim.pair.ecoul_self_atom(q)[
        torch.argsort(ts.sim.state.tag)]).numpy()
    assert close(own, j_eatom)


def test_hybrid_per_atom_tallies():
    """A hybrid's per-atom tallies are the sum of its sub-styles', their
    self-energy included: their sum is pe, and the virial's sum is the
    pressure's pair part."""
    from tpumd_torch.md import peratom as tpa
    _, tsim = run_both("hybrid/overlay")
    eatom, vatom = tpa.pair_bonded_tallies(tsim)
    n = tsim.natoms
    assert float(eatom.sum()) == pytest.approx(
        tsim.last_thermo["pe"] * n, rel=1e-12)
    v = tsim.last_thermo
    vol = v["vol"]
    pvir = float(vatom[:, :3].sum()) / (3 * vol)
    pkin = (n - 1) * v["temp"] / vol
    assert pkin + pvir == pytest.approx(v["press"], rel=1e-12)
