"""The chain slice end to end: the port against tpumd.

Generated chain decks (``bench_targets.chain_data`` + ``IN_CHAIN``: FENE
bead-spring chains, special_bonds fene, lj/cut 1.12 shifted, fix nve +
fix langevin, check yes every step) run through tpumd (float64, cell grid
forced, its CPU "lammps" RanMars stream) and through tpumd_torch on the
CPU in float64 (also "lammps").  The step-0 forces agree per atom matched
by tag (rtol 1e-10, atol 1e-12: summation order only), thermo agrees to
1e-10 relative at step 0 and after the run, the printed thermo rows and
rebuild counts are equal, and so are the grid, the kernel-bond setup and
the per-slot bond tables.  The decks cross rebuilds on the displacement
check, run on a 5^3 and a 2^3 grid (bonds at the minimum image), and
through a cell overflow that grows the cap and redoes a segment with the
same host draws.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.bench_targets import CHAIN_SANITY, CHAIN_STEP0, IN_CHAIN, \
    STEP0_RTOL, chain_data, gate_failures
from tpumd_torch.md.fix_langevin import FixLangevin
from tpumd_torch.script.parser import LammpsScript as TScript

# the suite runs in several worker processes on shared cores: keep the
# plain torch sweeps from oversubscribing them
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = {
    # 20 chains of 25 in 5x5x5 cells; 30 steps cross ~7 rebuilds
    "500_5cube": (500, 25, 30, None),
    # 6 chains of 10 in 2x2x2 cells: every partner is met at two images
    "60_2cube": (60, 10, 40, None),
    # cap 8, the lattice's occupancy of a 2x2x2 grid: a rebuild near step
    # 45 overflows, the cap grows and the segment is redone with the same
    # langevin draws
    "60_regrow": (60, 10, 60, 8),
}
KEYS = ("temp", "epair", "emol", "etotal", "press")


def _deck(tmp_path, natoms, chain_len, thermo=10):
    path = tmp_path / "data.chain"
    chain_data(path, natoms, chain_len)
    return IN_CHAIN.format(data=path).replace(
        "thermo          100", f"thermo          {thermo}")


def _run(script, deck, nsteps, cap):
    script.run_string(deck)
    sim = script.sim
    sim.verbose = False
    sim._cap_override = cap
    if isinstance(script, JScript):
        sim.neighbor_mode = "cellgrid"
    script.run_string("run 0")
    row0 = dict(sim.last_thermo)
    s = sim.state
    tags = np.asarray(s.tag)
    f0 = np.asarray(s.f)[tags > 0][np.argsort(tags[tags > 0])]
    bonds0 = {k: np.asarray(getattr(s, k))
              for k in ("tag", "molecule", "bond_tags", "bond_btypes")}
    script.run_string(f"run {nsteps}")
    return sim, row0, f0, bonds0


def _thermo_rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_chain_slice_matches_tpumd(deck, tmp_path):
    natoms, chain_len, nsteps, cap = DECKS[deck]
    text = _deck(tmp_path, natoms, chain_len)
    jsim, j0, jf0, jb = _run(JScript(), text, nsteps, cap)
    tsim, t0, tf0, tb = _run(TScript(device="cpu", dtype=torch.float64),
                             text, nsteps, cap)
    assert [fx.rng for fx in tsim.fixes if isinstance(fx, FixLangevin)] \
        == ["lammps"]
    assert dataclasses.asdict(jsim._neigh_cfg) == {
        **dataclasses.asdict(tsim._neigh_cfg), "exclude_bits": ()}
    assert min(tsim._neigh_cfg.nx, tsim._neigh_cfg.ny,
               tsim._neigh_cfg.nz) == (5 if natoms == 500 else 2)
    assert cap is None or tsim._neigh_cfg.cap > cap
    assert jsim._ctx.kernel_bond_excl and tsim._ctx.kernel_bond is not None
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    np.testing.assert_allclose(tf0, jf0, rtol=1e-10, atol=1e-12)
    for k in KEYS:
        assert t0[k] == pytest.approx(j0[k], rel=1e-10), k
        assert tsim.last_thermo[k] == pytest.approx(jsim.last_thermo[k],
                                                    rel=1e-10), k
    assert t0["emol"] > 0 and tsim.last_thermo["emol"] > 0
    assert tsim.step == jsim.step == nsteps
    assert _thermo_rows(tsim) == _thermo_rows(jsim)
    nbuilds = int(tsim._carry[1].nbuilds)
    assert nbuilds == int(jsim._carry[1].nbuilds) and nbuilds > 2
    tags = np.sort(tsim.state.tag.numpy())
    assert tags[tags > 0].tolist() == list(range(1, tsim.natoms + 1))


def test_device_rng_mode(tmp_path):
    """The "device" langevin mode (a torch.Generator seeded from the fix's
    seed; "auto" picks it on CUDA) runs the same deck on the CPU: the same
    seed repeats the trajectory, and the thermostat's kicks differ from
    the RanMars stream's while the step-0 row, which they do not reach,
    stays equal."""
    text = _deck(tmp_path, 60, 10)
    rows = {}
    for rng in ("device", "device", "lammps"):
        script = TScript(device="cpu", dtype=torch.float64)
        script.run_string(text)
        script.sim.verbose = False
        fx = script.sim.fixes[-1]
        fx.rng = rng
        script.run_string("run 20")
        rows.setdefault(rng, []).append(_thermo_rows(script.sim))
    assert rows["device"][0] == rows["device"][1]
    assert rows["device"][0][1] == rows["lammps"][0][1]        # step 0
    assert rows["device"][0][2:4] != rows["lammps"][0][2:4]
    assert FixLangevin(1, 1, 10, 5, device="cpu").rng == "lammps"
    assert FixLangevin(1, 1, 10, 5, device="cuda").rng == "device"
    # a re-setup between runs (here after `timestep`) carries the
    # generator on, where a fresh setup would restart its stream
    states = []
    for commands in ("run 0", "run 10\ntimestep 0.012\nrun 0"):
        script = TScript(device="cpu", dtype=torch.float64)
        script.run_string(text)
        script.sim.verbose = False
        script.sim.fixes[-1].rng = "device"
        script.run_string(commands)
        states.append(script.sim._carry[2][-1])
    assert not torch.equal(states[0], states[1])


def test_unported_chain_cases_raise(tmp_path):
    """What the LJ+FENE kernel does not take raises, naming itself; a
    per-tuple bond style beside lj/cut runs on the matrix engine."""
    text = _deck(tmp_path, 60, 10)
    for old, new, match in (
            ("special_bonds   fene", "special_bonds   charmm",
             "special list"),
            ("special_bonds   fene\n", "", "special list"),
            ("bond_coeff      1 30.0 1.5 1.0 1.0",
             "bond_coeff      1 30.0 1.6 1.0 1.0", "reach"),
            ("fix             2 all langevin 1.0 1.0 10.0 904297",
             "fix             2 all langevin 1.0 1.0 10.0 904297 zero yes",
             "langevin")):
        script = TScript(device="cpu", dtype=torch.float64)
        with pytest.raises(NotImplementedError, match=match):
            script.run_string(text.replace(old, new) + "run 0\n")
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_string(text.replace("bond_style      fene",
                                   "bond_style      harmonic").replace(
        "bond_coeff      1 30.0 1.5 1.0 1.0",
        "bond_coeff      1 30.0 1.0") + "run 0\n")
    assert not script.sim._ctx.is_cellgrid
    assert [st.name for st, _ in script.sim._ctx.bonded] == ["harmonic"]


def test_cli_runs_the_chain_deck(tmp_path):
    """python -m tpumd_torch reads the data file relative to the deck."""
    chain_data(tmp_path / "data.chain", 60, 10)
    deck = tmp_path / "in.chain"
    deck.write_text(IN_CHAIN.format(data="data.chain").replace(
        "thermo          100", "thermo          5") + "run 10\n")
    log = tmp_path / "log"
    out = subprocess.run(
        [sys.executable, "-m", "tpumd_torch", "-in", str(deck), "--device",
         "cpu", "--dtype", "f64", "-log", str(log)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    script = TScript(device="cpu", dtype=torch.float64)
    script.run_file(str(deck))
    rows = _thermo_rows(script.sim)
    assert len(rows) == 5     # header, steps 0, 5, 10, rebuild count
    assert [ln for ln in log.read_text().splitlines()
            if not ln.startswith(("Loop time", "Performance"))] == rows


def _chain_32k(script, tmp_path):
    chain_data(tmp_path / "data.chain")
    script.run_string(IN_CHAIN.format(data=tmp_path / "data.chain"))
    sim = script.sim
    sim.verbose = False
    if isinstance(script, JScript):
        sim.neighbor_mode = "cellgrid"
    script.run_string("run 0")
    row0 = dict(sim.last_thermo)
    script.run_string("run 100")
    return row0, dict(sim.last_thermo)


@pytest.mark.slow
def test_chain_targets_from_tpumd(tmp_path):
    """The 32k chain targets of bench_targets, regenerated by tpumd on the
    CPU in float64 (cell grid, RanMars langevin)."""
    row0, row100 = _chain_32k(JScript(), tmp_path)
    print("CHAIN_STEP0", {k: row0[k] for k in CHAIN_STEP0})
    print("CHAIN_SANITY", {k: row100[k] for k in CHAIN_SANITY})
    for k, v in CHAIN_STEP0.items():
        assert row0[k] == pytest.approx(v, rel=1e-12), k
    for k, (v, _) in CHAIN_SANITY.items():
        assert row100[k] == pytest.approx(v, rel=1e-9), k


@pytest.mark.slow
def test_32k_chain_deck_gates(tmp_path):
    """The 32,000-atom chain deck on the port (CPU, f64, RanMars langevin)
    against the step-0 and step-100 gates."""
    row0, row100 = _chain_32k(TScript(device="cpu", dtype=torch.float64),
                              tmp_path)
    assert not gate_failures(row0, {k: (v, STEP0_RTOL)
                                    for k, v in CHAIN_STEP0.items()})
    assert not gate_failures(row100, CHAIN_SANITY)
