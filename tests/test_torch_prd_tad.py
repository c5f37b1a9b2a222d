"""The port's prd and tad (md/prd.py, md/tad.py) against tpumd's, on the
CPU in f64.

* tpumd's seven PRD cases (tests/test_prd.py): the four scripted ones (no
  event, one event, coincident and correlated events, a dephase retry) run
  through both packages' PRD with the dynamics, quench and velocity draw
  stubbed; the event rows (step, clock, event, correlated, coincident,
  replica) and the next words of the RanPark select and clock streams and
  of each replica's RanMars dephase stream equal.  The prd command with no
  event, and a real event forced by a detector that fires on its third
  check, on the 3^3 fcc deck at T 0.1: rows equal, the stored event
  positions in the same basin (the loop-geom velocity draw hashes the
  quenched positions' last bits, which the two minimizers round
  differently), the run goes on; compute event/displace is 0 until bound.
* tpumd's TAD cases (tests/test_tad_hyper.py): the constants, and the
  scripted no-event, confident-event and revert-to-earliest runs, rows
  (step, event, ievent, status, barrier, margin, t_lo, delt_lo) equal; and
  a real TAD run on the 3^3 deck with one forced event, whose NEB runs on
  the band between the basin's and the candidate's minima.
* The replica commands' syntax errors.
"""

import numpy as np
import pytest
import torch

import tpumd.md.prd as jprd
import tpumd.md.tad as jtad
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.md import prd as tprd
from tpumd_torch.md import tad as ttad
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
PKGS = {"tpumd": (jprd, jtad), "port": (tprd, ttad)}
EVENT_KEYS = ("step", "clock", "event", "correlated", "coincident",
              "replica")
TAD_KEYS = ("step", "event", "ievent", "status", "barrier", "margin",
            "t_lo", "delt_lo")


class FakeDet:
    """A detector whose checks pop scripted results (False once spent)."""

    def __init__(self, script):
        self.script = list(script)
        self.stored = []

    def check(self, sim, carry):
        return self.script.pop(0) if self.script else False

    def store(self, sim, carry):
        self.stored.append(carry)


class FakeState:
    def __init__(self, v=None):
        self.v = np.ones(3) if v is None else v

    def replace(self, **kw):
        return FakeState(v=kw.get("v", self.v))


class FakeSim:
    def __init__(self):
        self._ctx = type("C", (), {"dt": 0.01})()
        self._carry = (FakeState(),)
        self.state = None
        self.step = 0
        self.verbose = False
        self.units = type("U", (), {"boltz": 1.0})()

    def recompute_output(self):
        pass


def scripted_prd(pkg, script, nrep=2, seed=1234):
    base = PKGS[pkg][0].PRD

    class Scripted(base):
        def _dynamics(self, carry, step, nsteps):
            self.calls.append(("dyn", step, nsteps))
            return carry

        def _quench(self, carry, step):
            self.calls.append(("quench", step))
            return carry

        def _randomize_velocities(self, carry, seed):
            return carry

    r = Scripted(FakeSim(), nrep, FakeDet(script), seed, temp=1.0)
    r.calls = []
    return r


def words(runner):
    return ([runner.random_select.uniform(), runner.random_clock.uniform()]
            + [g.uniform() for g in runner.random_dephase])


def rows(events, keys=EVENT_KEYS):
    return [tuple(e[k] for k in keys) for e in events]


PRD_CASES = {
    "no_event": ([False] * 20, 2, 1234, (40, 10, 1, 5, 20)),
    "single_event": ([False] * 4 + [True, False], 2, 1234,
                     (40, 10, 1, 5, 20)),
    "coincident_correlated": ([False, False, True, True, True, False,
                               False], 2, 77, (60, 10, 1, 5, 20)),
    "dephase_retry": ([True, False, False] + [False] * 10, 2, 1234,
                      (20, 10, 1, 5, 0)),
}


@pytest.mark.parametrize("case", sorted(PRD_CASES))
def test_prd_scripted(case):
    script, nrep, seed, args = PRD_CASES[case]
    out = {}
    for pkg in PKGS:
        r = scripted_prd(pkg, script, nrep, seed)
        ev = r.run(*args)
        out[pkg] = (rows(ev), r.clock, r.event_clock, r.calls, words(r))
    assert out["port"] == out["tpumd"]
    if case == "single_event":
        ev = out["port"][0][1]
        frac = int(tprd.RanPark(seed + 1000).uniform() * 10)
        assert ev == (20, 40 - (10 - frac) * 2, 1, 0, 1, 0)


DECK = """
units           lj
atom_style      atomic
lattice         fcc 1.0
region          box block 0 3 0 3 0 3
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 1 check yes
velocity        all create 0.1 87287 loop geom
fix             1 all nve
compute         ev all event/displace 0.9
"""


def build(pkg):
    sc = (JScript() if pkg == "tpumd"
          else TScript(device="cpu", dtype=torch.float64))
    sc.run_string(DECK)
    sc._finalize_atoms()
    sc.sim.verbose = False
    sc.sim.thermo_every = 0
    return sc


def tag_x(sc):
    import jax
    s = sc.sim.state
    x = np.asarray(jax.device_get(s.x) if not torch.is_tensor(s.x)
                   else s.x.cpu().numpy(), np.float64)
    tag = np.asarray(jax.device_get(s.tag) if not torch.is_tensor(s.tag)
                     else s.tag.cpu().numpy())
    out = np.zeros((int((tag > 0).sum()), 3))
    out[tag[tag > 0] - 1] = x[tag > 0]
    return out


def test_prd_command_no_event():
    out = {}
    for pkg in PKGS:
        sc = build(pkg)
        sc.execute("prd 20 10 1 10 0 ev 482794 temp 0.1 replicas 2")
        out[pkg] = rows(sc.prd_events)
        sc.sim.run(2)
        assert sc.sim.step == 22
    assert out["port"] == out["tpumd"] == [(0, 0, 0, 0, 0, 0)]


@pytest.fixture(scope="module")
def forced_prd():
    """Both packages' PRD with a detector that fires on its third check
    (after the two dephase checks): the first search segment's replica 0
    holds the event."""
    out = {}
    for pkg, (mod, _) in PKGS.items():
        sc = build(pkg)
        sim = sc.sim
        sim.setup()

        class OneShot(mod.EventDetector):
            n = 0

            def check(self, sim, carry):
                self.n += 1
                return self.n == 3

        det = OneShot(0.9)
        runner = mod.PRD(sim, 2, det, 9871, temp=0.3, etol=1e-8, ftol=1e-8,
                         maxiter=200, maxeval=200)
        events = runner.run(nsteps=20, t_event=10, n_dephase=1, t_dephase=5,
                            t_corr=0)
        xev = det.xevent
        xev = (xev.cpu().numpy() if torch.is_tensor(xev)
               else np.asarray(xev))
        out[pkg] = (sc, rows(events), xev, words(runner))
    return out


def test_prd_real_event_shares_state(forced_prd):
    """Rows and random words equal; the stored event state (replica 0's
    quench, shared by every replica) sits in the basin tpumd's does.  The
    two packages' quenched positions differ in their last bits, and the
    loop-geom draw hashes those bits, so the dephased trajectories (and
    the unconverged quenches after them) are not compared elementwise."""
    j, t = forced_prd["tpumd"], forced_prd["port"]
    assert t[1] == j[1]
    assert t[1][1][0] == 10 and t[1][1][5] == 0 and len(t[1]) == 2
    assert t[3] == j[3]
    assert np.abs(t[2] - j[2]).max() < 0.05
    t[0].sim.run(3)
    assert t[0].sim.step == 23


def test_event_displace_compute_inactive():
    sc = build("port")
    sc.sim.setup()
    assert float(sc.sim.computes["ev"](sc.sim)) == 0.0


# ----------------------------------------------------------------- TAD
def scripted_tad(pkg, det_script, barriers, templo=0.3, temphi=0.9,
                 delta_conf=0.1, tmax=1.0):
    base = PKGS[pkg][1].TAD

    class Scripted(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.barriers = list(barriers)

        def _dynamics(self, carry, step, nsteps):
            return carry

        def _quench(self, carry, step):
            return carry

        def _perform_neb(self, basin_q, q, step):
            return self.barriers.pop(0)

    return Scripted(FakeSim(), FakeDet(det_script), templo, temphi,
                    delta_conf, tmax)


def test_tad_constants():
    for pkg in PKGS:
        t = scripted_tad(pkg, [], [])
        assert t.deltconf == pytest.approx(-np.log(0.1) / 0.01, rel=1e-15)
        assert t.delta_beta == pytest.approx(1 / 0.3 - 1 / 0.9, rel=1e-15)
        assert t.ratio_beta == pytest.approx(1 / 3, rel=1e-15)


TAD_CASES = {
    "no_event": ([False] * 10, [], 1.0, (40, 10)),
    "confident": ([True], [0.01], 0.001, (40, 10)),
    "revert_earliest": ([False, True, True], [3.0, 0.001], 0.01, (60, 10)),
}


@pytest.mark.parametrize("case", sorted(TAD_CASES))
def test_tad_scripted(case):
    det, barriers, tmax, args = TAD_CASES[case]
    out = {}
    for pkg in PKGS:
        t = scripted_tad(pkg, det, barriers, tmax=tmax)
        out[pkg] = (rows(t.run(*args), TAD_KEYS), t.sim.step, t.tlo)
    assert out["port"] == out["tpumd"]
    if case == "revert_earliest":
        assert [r[3] for r in out["port"][0]] == ["E ", "DF", "DF", "E "]


def test_tad_forced_event_neb():
    """A real TAD run with one forced event at step 10: its NEB runs on the
    band between the basin's and the candidate's minima (the same basin
    here: a barrier near zero), the event is confident at once and
    performed; both packages' rows equal.  tpumd stops there (its carried
    neighbour matrix keeps the K from before the NEB grew it, and its next
    segment raises); the port runs on to step 20."""
    out = {}
    for pkg, (mod, tmod) in PKGS.items():
        sc = build(pkg)
        sim = sc.sim
        sim.setup()

        class OneShot(mod.EventDetector):
            n = 0

            def check(self, sim, carry):
                self.n += 1
                return self.n == 1

        runner = tmod.TAD(sim, OneShot(0.9), 0.1, 0.5, 0.1, 0.001,
                          etol=1e-8, ftol=1e-8, maxiter=100, maxeval=100,
                          etol_neb=0.0, ftol_neb=1e-6, n1_neb=10, n2_neb=10,
                          nevery_neb=5, neb_replicas=3)
        ev = runner.run(10, 10)
        out[pkg] = rows(ev, TAD_KEYS)
        assert sim.step == 10
        if pkg == "port":
            more = runner.run(10, 10)
            assert sim.step == 20 and more[-1]["status"] == "E "
    t, j = out["port"], out["tpumd"]
    assert [r[:4] for r in t] == [r[:4] for r in j]
    np.testing.assert_allclose([r[4:] for r in t], [r[4:] for r in j],
                               rtol=0, atol=1e-4)
    assert [r[3] for r in t] == ["E ", "DF", "E "]


@pytest.mark.parametrize("line,err", [
    ("prd 20 10 1 10 0 ev 482794", "replicas"),
    ("prd 25 10 1 10 0 ev 482794 replicas 2", "multiple of t_event"),
    ("prd 20 10 1 10 0 nope 1 replicas 2", "event/displace"),
    ("tad 20 10 0.1 0.5 0.1 1.0 ev bogus 1", "unknown tad keyword"),
    ("hyper 20 10 1 ev", "hyper/global"),
    ("neb 0 0.01 10 10 5 final f.neb replicas 3", "fix neb"),
])
def test_replica_command_errors(line, err):
    sc = build("port")
    with pytest.raises(Exception, match=err):
        sc.execute(line)
