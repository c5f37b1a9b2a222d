"""The script layer of the port against tpumd: variables, formulas, flow
control, thermo columns of variables and computes, and -var overrides.

Each case runs the same input through tpumd (float64 on the CPU, as
tpumd's own tests run it) and through tpumd_torch on the CPU in float64.
Printed text must be equal; a formula's value equal to 1e-12 of the
largest value of that formula.  The flow cases are those of
tests/test_script_flow.py; tests/golden/script_flow/in.test must print
exactly the reference binary's prints.txt.
"""

import os

import numpy as np
import pytest
import torch

from tpumd.script.formula import Formula as JFormula
from tpumd.script.formula import SimFormulaContext as JContext
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.__main__ import main as torch_main
from tpumd_torch.bench_targets import IN_LJ, IN_LJ_BENCH
from tpumd_torch.script.formula import Formula as TFormula
from tpumd_torch.script.formula import SimFormulaContext as TContext
from tpumd_torch.script.parser import LammpsScript as TScript, ScriptError

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden", "script_flow")


def both():
    """A tpumd script and a port script (CPU, f64)."""
    return JScript(), TScript(device="cpu", dtype=torch.float64)


def printed(capsys, script, run):
    """What running ``run(script)`` printed, blank lines dropped."""
    capsys.readouterr()
    run(script)
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def test_script_flow_golden(capsys, monkeypatch):
    monkeypatch.setenv("TPUMD_TEST_ENV", "hello")
    with open(os.path.join(GOLD, "prints.txt")) as fh:
        want = [ln for ln in fh.read().splitlines() if ln.strip()]
    for s in both():
        got = printed(capsys, s,
                      lambda s: s.run_file(os.path.join(GOLD, "in.test")))
        assert got == want, type(s).__module__


FLOW = {
    # (files beside the main deck, main deck, lines that must print)
    "include": ({"sub.in": 'print "FROM_INCLUDE"\n'},
                'include sub.in\nprint "AFTER"\n',
                ["FROM_INCLUDE", "AFTER"]),
    "jump_to_file": ({"other.in": 'label here\nprint "OTHER"\n'},
                     "jump other.in here\n", ["OTHER"]),
    "python_variable": ({}, 'variable a equal 4\n'
                        'python sq input 1 v_a return v_out format ff here '
                        '"def sq(x): return x*x"\n'
                        'variable out python sq\nprint "SQ ${out}"\n',
                        ["SQ 16.0"]),
    "python_string_format": ({}, 'python greet input 1 world return v_g '
                             'format ss here "def greet(w): return '
                             '\'hi-\' + w"\nvariable g python greet\n'
                             'print "G ${g}"\n', ["G hi-world"]),
    "if_string_compare": ({}, 'variable s string abc\n'
                          'if "${s} == abc" then "print YES" else '
                          '"print NO"\n', ["YES"]),
    "loop_and_format": ({}, 'variable n loop 3\nlabel top\n'
                        'variable y equal $n*1.5\n'
                        'variable f format y %.3f\nprint "N $n ${f}"\n'
                        'next n\njump SELF top\nprint END\n',
                        ["N 1 1.500", "N 2 3.000", "N 3 4.500", "END"]),
}


@pytest.mark.parametrize("case", sorted(FLOW))
def test_flow(case, tmp_path, capsys):
    files, deck, want = FLOW[case]
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    main = tmp_path / "in.main"
    main.write_text(deck)
    outs = [printed(capsys, s, lambda s: s.run_file(str(main)))
            for s in both()]
    assert outs[0] == outs[1] == want


def test_atomfile_variable(tmp_path):
    # two sections; missing tags default to 0 (Variable::reader ATOMFILE)
    af = tmp_path / "vals.af"
    af.write_text("# comment\n2\n1 1.5\n3 2.5\n1\n2 9.0\n")
    for s in both():
        s.run_string(
            "units lj\nlattice fcc 0.8442\nregion box block 0 2 0 2 0 2\n"
            "create_box 1 box\ncreate_atoms 1 box\n")
        s.execute(f"variable q atomfile {af}")
        v = s.evaluate_variable("q")
        assert len(v) == 32 and v[0] == 1.5 and v[2] == 2.5 and v[1] == 0.0
        s.execute("next q")
        v = s.evaluate_variable("q")
        assert v[1] == 9.0 and v[0] == 0.0
        # exhausting deletes the variable and skips the following jump
        s.execute("next q")
        assert "q" not in s.variables and s._skip_jump


def test_shell_builtins(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k, s in enumerate(both()):
        s.execute(f"shell mkdir outdir{k}")
        assert (tmp_path / f"outdir{k}").is_dir()
        s.execute(f"shell putenv TPUMD_SHELL_TEST=v{k}")
        assert os.environ.get("TPUMD_SHELL_TEST") == f"v{k}"
        (tmp_path / "gone.txt").write_text("x")
        s.execute("shell rm gone.txt")
        assert not (tmp_path / "gone.txt").exists()


# the 4^3 in.lj deck, every pair summed at every step on both engines
# (tpumd's matrix engine on the CPU, the port's cell grid), with its atoms
# moved off the lattice (bit-equal in both: RanPark on the coordinates) so
# that the forces are not the lattice's cancelling ones
DECK4 = IN_LJ.format(n=4).replace("delay 0 every 20 check no",
                                  "delay 0 every 1 check yes") \
    + "displace_atoms all random 0.05 0.05 0.05 4187 units box\n"

EXPRESSIONS = [
    "2+3*4-6/3", "2^3^2", "-2^2", "(1<2)&&(3>=3)||0", "!0+(7%3)",
    "(2==2)+(2!=2)+(1<=0)+(3>2)",
    "sqrt(16)+exp(1)+ln(2)+log(100)+abs(-3)",
    "sin(PI/6)+cos(0.2)+tan(0.3)+asin(0.5)+acos(0.5)+atan(1)+atan2(1,2)",
    "floor(2.7)+ceil(2.1)+round(2.5)+pow(2,10)+min(3,4)+max(3,4)",
    "temp", "pe", "ke", "etotal", "press", "vol", "epair", "atoms", "step",
    "dt", "time", "lx*ly*lz", "density", "v_a*2+v_b", "c_thermo_temp",
    "x", "y", "z", "vx", "vy", "fx", "fz", "id", "type", "mass",
    "x+vx*2-fx*id", "(fx>0)*type",
]


@pytest.fixture(scope="module")
def deck4_pair():
    scripts = both()
    for s in scripts:
        deck = DECK4 + "variable a equal 3\nvariable b equal temp*2\n"
        if isinstance(s, JScript):
            # the port has the reference's thermo_temp compute built in
            deck += "compute thermo_temp all temp\n"
        s.run_string(deck)
        s.sim.verbose = False
        s.run_string("run 3")
    return scripts


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_formula(expr, deck4_pair):
    js, ts = deck4_pair
    a = np.asarray(JFormula(expr).evaluate(JContext(js.sim, js)),
                   np.float64)
    b = np.asarray(TFormula(expr).evaluate(TContext(ts.sim, ts)),
                   np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(a).max()), 1e-300)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * scale)


def _rows(sim):
    return [ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


def test_thermo_variable_columns():
    rows = []
    for s in both():
        deck = IN_LJ.format(n=4).replace(
            "delay 0 every 20 check no", "delay 0 every 1 check yes") + (
            "variable e equal etotal/atoms\nthermo 5\n"
            "thermo_style custom step temp v_e c_thermo_temp\n")
        if isinstance(s, JScript):
            deck += "compute thermo_temp all temp\n"
        s.run_string(deck)
        s.sim.verbose = False
        s.run_string("run 20")
        rows.append(_rows(s.sim))
    assert rows[0] == rows[1]
    assert rows[0][0].split() == ["Step", "Temp", "v_e", "c_thermo_temp"]
    assert len(rows[0]) == 1 + 5 + 1


def test_var_substitution_deck():
    """variable n equal 4*$x sizes the region: step 0 as tpumd's."""
    rows = []
    for s in both():
        s.run_string("variable x index 1\nvariable n equal 4*$x\n"
                     + IN_LJ.replace("{n}", "$n"))
        s.sim.verbose = False
        s.run_string("run 0")
        rows.append(_rows(s.sim))
        assert s.sim.natoms == 256
    assert rows[0] == rows[1]


@pytest.mark.parametrize("xyz,natoms", [((1, 1, 1), 32000),
                                        ((2, 1, 1), 64000)])
def test_in_lj_bench_var_overrides(xyz, natoms):
    """LAMMPS's bench/in.lj with -var x/y/z, up to create_atoms: the box
    and the atom count of tpumd's."""
    pre = IN_LJ_BENCH.split("mass")[0]
    over = dict(zip("xyz", xyz))
    got = []
    for s in (JScript(var_overrides=over),
              TScript(device="cpu", dtype=torch.float64,
                      var_overrides=over)):
        s.run_string(pre)
        # the deck's own `variable x index 1` does not overwrite -var
        assert [s.variables[k][1] for k in "xyz"] == [str(v) for v in xyz]
        got.append((sum(len(x) for x in s._atoms_x),
                    np.asarray(s.box[0], np.float64),
                    np.asarray(s.box[1], np.float64)))
    assert got[0][0] == got[1][0] == natoms
    for a, b in zip(got[0][1:], got[1][1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1][2], 20 * np.array(xyz) * (
        4 / 0.8442) ** (1 / 3), rtol=1e-14)


def test_cli_var_and_log(tmp_path, capsys):
    """python -m tpumd_torch -in deck -var n 4 -log file -echo screen -sf
    x: the -var value sizes the region; the log holds the thermo."""
    deck = tmp_path / "in.deck"
    deck.write_text("variable n index 9\n" + IN_LJ.replace("{n}", "$n")
                    + "run 0\n")
    log = tmp_path / "log.out"
    assert torch_main(["-in", str(deck), "-var", "n", "4", "-log", str(log),
                       "-echo", "screen", "-sf", "gpu", "--device", "cpu",
                       "--dtype", "f64"]) == 0
    out = capsys.readouterr().out
    assert "region          box block 0 4 0 4 0 4" in out   # echoed
    lines = log.read_text().splitlines()
    assert lines[0].split()[:2] == ["Step", "Temp"]
    assert lines[1].split()[:3] == ["0", "1.44", "-6.7733681"]
    assert "with 256 atoms" in log.read_text()


def test_unported_command_names_itself():
    """A command of the reference that tpumd lacks (kim_init) raises
    naming itself; the replica commands are ported and raise on what
    their lines lack."""
    s = TScript(device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="kim_init"):
        s.execute("kim_init LennardJones_Ar real")
    for line, match in (("neb 0.0 0.01 100 100 10 final f", "fix neb"),
                        ("temper 1000 100 300 3 0 5", "world-style"),
                        ("prd 100 10 10 100 0 ev 2", "replicas")):
        with pytest.raises(ScriptError, match=match):
            s.execute(line)


def test_in_lj_bench_equals_expanded_deck():
    """bench/in.lj at -var x 1 -var y 1 -var z 1, its run line as
    run 0: the step-0 rows of bench_targets' expanded IN_LJ (n = 20)."""
    rows = []
    for deck, over in ((IN_LJ_BENCH.rsplit("\nrun", 1)[0], {"x": 1, "y": 1,
                                                          "z": 1}),
                       (IN_LJ.format(n=20), None)):
        s = TScript(device="cpu", dtype=torch.float64, var_overrides=over)
        s.run_string(deck)
        s.sim.verbose = False
        s.run_string("run 0")
        rows.append(_rows(s.sim))
    assert rows[0] == rows[1]
    assert rows[0][1].split()[:3] == ["0", "1.44", "-6.7733681"]


def test_log_timer_info(tmp_path, capsys):
    """log writes the thermo rows from there on (as tpumd's), timer
    timeout 0 stops a run at its first segment boundary, info prints its
    categories."""
    logs = []
    for k, s in enumerate(both()):
        quiet_deck = DECK4.replace("displace_atoms", "thermo 2\n"
                                   "displace_atoms")
        s.run_string(quiet_deck)
        s.sim.verbose = False
        s.run_string(f"log {tmp_path}/log.{k}\nrun 4\nlog none\nrun 2")
        logs.append((tmp_path / f"log.{k}").read_text().splitlines())
    rows = [[ln for ln in lg if ln.split() and ln.split()[0].isdigit()]
            for lg in logs]
    assert rows[0] == rows[1] and [r.split()[0] for r in rows[0]] == [
        "0", "2", "4"]
    t = both()[1]
    t.run_string(DECK4 + "thermo 2\ntimer timeout 0 every 1\n")
    t.sim.verbose = False
    t.run_string("run 10")
    assert t.sim.step == 2 and "Wall time limit reached" in t.sim.log_lines
    capsys.readouterr()
    t.run_string("info system groups fixes variables")
    out = capsys.readouterr().out
    for want in ("Info-Info-Info: system", "natoms = 256",
                 "pair_style = lj/cut", "fix 1 style nve"):
        assert want in out


def test_jump_self_without_label(capsys):
    """jump SELF with no label goes back to the top of the file, as the
    reference's Input::jump rewinds it (tpumd goes on after the jump
    instead, ROADMAP C10): a loop variable keeps its value when the top
    redefines it, and its exhaustion skips the jump."""
    s = TScript(device="cpu", dtype=torch.float64)
    got = printed(capsys, s, lambda s: s.run_string(
        "variable a loop 3\nprint \"A $a\"\nnext a\njump SELF\n"
        "print DONE\n"))
    assert got == ["A 1", "A 2", "A 3", "DONE"]
