"""kspace on the matrix neighbor engine: PPPM and Ewald beside the coul/long
styles, the port against tpumd on the CPU in float64, and the molten-salt
replication identities that chip_smoke.py's salt phase gates on.

* PPPM with coul/long, lj/cut/coul/long and born/coul/long on a 512-ion
  salt (tests/golden/wolfdsf/data.salt replicated 2x2x2, the ions moved
  off the lattice): the kspace solver's forces, elong and virial on the
  set-up state, and the step-0 forces and rows, to 1e-10 relative.
* kspace_style ewald against tpumd's Ewald on the same ions, the same.
* lj/charmm/coul/long under PPPM on an atom_style charge deck: 10 steps,
  every printed row equal to tpumd's matrix engine to 1e-10.
* a hybrid/overlay of lj/cut and coul/long under PPPM equals
  lj/cut/coul/long (its cut_coul and g_ewald are the coul/long
  sub-style's); tpumd's hybrid takes no kspace.
* The replication identity: a replicated perfect lattice has its cell's
  energies per ion.  born/coul/dsf: the 2x2x2 salt's step-0 epair and
  ecoul equal the 64-ion cell's to 1e-12.  born/coul/long under PPPM
  1e-4: the 64-ion cell's exact lattice sum (ewald 1e-10) is
  ``SALT_EWALD_STEP0``; the 512-ion cell's PPPM rows
  (``SALT_PPPM_STEP0``) miss it by 3.41e-5 (epair) and 2.14e-5 (ecoul +
  elong) relative, so the gate is ``SALT_PPPM_EWALD_RTOL`` = 5e-5; and
  PPPM picks the same g_ewald and mesh spacing for every larger replica,
  so the 4x4x4 cell's rows equal the 512-ion cell's to 1e-12 (the 32k
  deck's rows on the card are held to them).
* The coupling test reads cut_coul and g_ewald, not the grid's
  ``charged`` flag: a coul/long style with PPPM sets up on the matrix
  engine; lj/cut with kspace_style pppm raises, naming the pair style.
"""

import os

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bench_targets as bt
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "wolfdsf")

SALT = """units lj
atom_style charge
read_data {gold}/data.salt
{replicate}
{displace}
{pair}
{kspace}
velocity all create 1.0 87287 loop geom
neighbor 0.3 bin
neigh_modify delay 0 every 1
fix 1 all nve
timestep 0.004
thermo_style custom step temp epair ecoul elong etotal press
"""

PAIRS = {
    "coul/long": "pair_style coul/long 3.2\npair_coeff * *",
    "lj/cut/coul/long": "pair_style lj/cut/coul/long 1.5 3.2\n"
                        "pair_coeff * * 0.2 1.0",
    "born/coul/long": "pair_style born/coul/long 3.2\n"
                      "pair_coeff * * 1.5 0.4 1.2 1.0 0.5",
}


def salt(pair, kspace, rep=2, displace=True):
    return SALT.format(
        gold=GOLD, replicate=f"replicate {rep} {rep} {rep}" if rep > 1 else "",
        displace=("displace_atoms all random 0.12 0.12 0.12 9127"
                  if displace else ""), pair=pair, kspace=kspace)


def both(deck):
    js, ts = JScript(), TScript(device="cpu", dtype=torch.float64)
    for script in (js, ts):
        script.run_string(deck)
        script.sim.neighbor_mode = "matrix"
        script.run_string("run 0")
    return js.sim, ts.sim


def tag_sorted(f, tag):
    return np.asarray(f)[np.argsort(np.asarray(tag))]


def close(a, b, rel=1e-10):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and float(np.abs(a - b).max()) <= rel * float(
        np.abs(b).max())


def check_kspace(jsim, tsim):
    js, ts = jsim.state, tsim.state
    jf, je, jv = jsim.kspace.compute(js, True, True)
    tf, te, tv = tsim.kspace.compute(ts.x, ts.q, ts.box, True, True)
    assert close(tag_sorted(tf, ts.tag), tag_sorted(jf, js.tag))
    assert abs(float(te) - float(je)) <= 1e-10 * abs(float(je))
    assert close(tv, jv)
    assert close(tag_sorted(ts.f, ts.tag), tag_sorted(js.f, js.tag))
    for key in ("epair", "ecoul", "elong", "press"):
        a, b = tsim.last_thermo[key], jsim.last_thermo[key]
        assert abs(a - b) <= 1e-10 * abs(b), (key, a, b)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_pppm_matrix_against_tpumd(pair):
    jsim, tsim = both(salt(PAIRS[pair], "kspace_style pppm 1e-4"))
    assert not tsim._ctx.is_cellgrid and tsim.kspace.style == "pppm"
    assert (tsim.kspace.nx, tsim.kspace.ny, tsim.kspace.nz) == (
        jsim.kspace.nx, jsim.kspace.ny, jsim.kspace.nz)
    assert tsim.kspace.g_ewald == pytest.approx(jsim.kspace.g_ewald,
                                                rel=1e-14)
    check_kspace(jsim, tsim)


def test_ewald_against_tpumd():
    jsim, tsim = both(salt(PAIRS["born/coul/long"],
                           "kspace_style ewald 1e-6"))
    assert tsim.kspace.style == "ewald"
    assert len(tsim.kspace.kvecs) == len(jsim.kspace.kvecs)
    assert np.array_equal(tsim.kspace.kvecs, jsim.kspace.kvecs)
    check_kspace(jsim, tsim)


CHARMM = """units lj
atom_style charge
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 2 box
create_atoms 1 box
region left block 0 2 0 4 0 4
set region left type 2
set type 1 charge 0.5
set type 2 charge -0.5
mass * 1.0
velocity all create 1.44 87287 loop geom
pair_style lj/charmm/coul/long 2.0 2.5
pair_coeff 1 1 1.0 1.0
pair_coeff 2 2 0.8 1.1
kspace_style pppm 1e-4
neighbor 0.3 bin
neigh_modify delay 0 every 5 check no
fix 1 all nve
thermo 5
"""


def test_charmm_long_pppm_matrix_rows():
    rows = []
    for script in (JScript(), TScript(device="cpu", dtype=torch.float64)):
        script.run_string(CHARMM)
        script.sim.neighbor_mode = "matrix"
        script.run_string("run 10")
        rows.append([[float(v) for v in ln.split()]
                     for ln in script.sim.log_lines
                     if ln.split() and ln.split()[0].isdigit()])
    assert len(rows[1]) == len(rows[0]) == 3
    for g, w in zip(rows[1], rows[0]):
        assert g == pytest.approx(w, rel=1e-10, abs=1e-12)


def test_charmm_long_without_bonds_goes_to_the_matrix():
    """"auto" sends lj/charmm/coul/long without special lists to the
    matrix engine: the grid's sweep (B5) reads them."""
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(CHARMM + "run 0")
    assert script.sim._mode == "matrix"


def test_hybrid_coul_long_under_pppm():
    single = PAIRS["lj/cut/coul/long"]
    hybrid = ("pair_style hybrid/overlay lj/cut 1.5 coul/long 3.2\n"
              "pair_coeff * * lj/cut 0.2 1.0\npair_coeff * * coul/long")
    out = []
    for pair in (single, hybrid):
        script = TScript(device="cpu", dtype=torch.float64)
        script.run_string(salt(pair, "kspace_style pppm 1e-4") + "run 0")
        out.append(script.sim)
    a, b = out
    assert b.pair.g_ewald == a.pair.g_ewald > 0
    assert close(b.state.f, a.state.f, 1e-12)
    for key in ("epair", "ecoul", "elong", "press"):
        assert b.last_thermo[key] == pytest.approx(a.last_thermo[key],
                                                   rel=1e-12)


def step0(deck):
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(deck + "run 0")
    return script.sim


DSF = ("pair_style born/coul/dsf 0.5 2.8 3.2\n"
       "pair_coeff * * 1.5 0.4 1.2 1.0 0.5")


def test_replication_identity_dsf():
    one, eight = (step0(salt(DSF, "", rep, False)).last_thermo
                  for rep in (1, 2))
    for key in ("epair", "ecoul"):
        assert eight[key] == pytest.approx(one[key], rel=1e-12)
    # the card's IN_SALT32K_DSF gate at 2x2x2: log.borndsf's step 0
    sim = step0(bt.IN_SALT32K_DSF.format(golden=GOLD).replace(
        "replicate       8 8 8", "replicate       2 2 2"))
    assert sim.natoms == 512
    assert bt.salt_step0_failures(sim.last_thermo, True, 512,
                                  16.0 ** 3, 1e-8) == []


def test_replication_identity_pppm():
    born = PAIRS["born/coul/long"]
    ewald = step0(salt(born, "kspace_style ewald 1e-10", 1, False))
    v = ewald.last_thermo
    assert v["epair"] == pytest.approx(bt.SALT_EWALD_STEP0["epair"],
                                       rel=1e-12)
    assert v["ecoul"] + v["elong"] == pytest.approx(
        bt.SALT_EWALD_STEP0["coul"], rel=1e-12)
    two, four = (step0(bt.IN_SALT32K.format(golden=GOLD).replace(
        "replicate       8 8 8", f"replicate       {r} {r} {r}"))
        for r in (2, 4))
    for key, want in bt.SALT_PPPM_STEP0.items():
        assert two.last_thermo[key] == pytest.approx(want, rel=1e-12)
        assert four.last_thermo[key] == pytest.approx(want, rel=1e-12)
    assert (four.kspace.nx, four.kspace.g_ewald) == (
        2 * two.kspace.nx, two.kspace.g_ewald)
    # the PPPM error against the exact sum, the gate's tolerance
    p = two.last_thermo
    err_epair = abs(p["epair"] / bt.SALT_EWALD_STEP0["epair"] - 1)
    err_coul = abs((p["ecoul"] + p["elong"]) / bt.SALT_EWALD_STEP0["coul"]
                   - 1)
    assert 3.3e-5 < err_epair < 3.5e-5 and 2.0e-5 < err_coul < 2.3e-5
    assert max(err_epair, err_coul) < bt.SALT_PPPM_EWALD_RTOL
    for sim in (two, four):
        assert bt.salt_step0_failures(sim.last_thermo, False, sim.natoms,
                                      0.0, 1e-12) == []


def test_kspace_coupling_reads_cut_coul():
    sim = step0(salt(PAIRS["born/coul/long"], "kspace_style pppm 1e-4", 1))
    assert sim._mode == "matrix" and sim.pair.g_ewald == sim.kspace.g_ewald
    assert not getattr(sim.pair, "charged", False)
    with pytest.raises(NotImplementedError, match="pair_style lj/cut"):
        step0(salt("pair_style lj/cut 2.5\npair_coeff * * 1.0 1.0",
                   "kspace_style pppm 1e-4", 1))
    with pytest.raises(NotImplementedError, match="kspace_style msm"):
        step0(salt(PAIRS["coul/long"], "kspace_style msm 1e-4", 1))


def test_salt_drift_of_the_deck():
    """IN_SALT32K's own energy drift over its 1,000 steps, in f64 at
    2x2x2: 4.4585e-3 (tpumd's run of the same deck prints the same rows),
    within SALT_DRIFT_TOL, the gate the card's f32 run meets."""
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(bt.IN_SALT32K.format(golden=GOLD).replace(
        "replicate       8 8 8", "replicate       2 2 2"))
    script.sim.verbose = False
    script.run_string(f"run {bt.SALT32K_STEPS}")
    e = np.array([float(ln.split()[-2]) for ln in script.sim.log_lines
                  if ln.split() and ln.split()[0].isdigit()])
    assert len(e) == 11
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    assert drift == pytest.approx(4.4585057e-3, rel=1e-6)
    assert drift < bt.SALT_DRIFT_TOL
