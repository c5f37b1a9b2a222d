"""LAMMPS-dialect input-script front end for the port.

The port of tpumd/script/parser.py (the reference's Input interpreter,
src/input.cpp:195 file loop, :382 line parse, :764 dispatch): line
continuation (&), comment stripping, ``$x``/``${name}`` variable
substitution, a program counter per script frame so that ``jump``,
``label`` and ``next`` can loop, and an order-sensitive command state
machine driving a ``Simulation``.  Styles named before read_data are made
once it has set the type counts.  Any other command raises
NotImplementedError naming itself.
"""

from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import torch

from tpumd_torch.core.atomvec import get_style
from tpumd_torch.core.create import create_atoms_lattice, remap_host, \
    remap_triclinic_host
from tpumd_torch.core.lattice import Lattice
from tpumd_torch.core.region import BlockRegion, ConeRegion, \
    CylinderRegion, EllipsoidRegion, IntersectRegion, OutsideRegion, \
    PlaneRegion, PrismRegion, Region, SphereRegion, UnionRegion
from tpumd_torch.core.state import Box, make_state, map_per_atom
from tpumd_torch.core.velocity_cmd import velocity_create_geom, \
    velocity_ramp, velocity_scale, velocity_set, zero_momentum, \
    zero_rotation
from tpumd_torch.io.dump import make_dump
from tpumd_torch.io.molecule import MoleculeTemplate, axisangle_to_quat, \
    norm3_np, quat_to_mat_np, rotate_place_np
from tpumd_torch.io.read_data import build_special, read_data
from tpumd_torch.io.restart import read_restart, write_data, \
    write_restart
from tpumd_torch.md.fix_bond_mc import FixBondBreakMC, FixBondCreateMC
from tpumd_torch.md.fix_langevin import FixLangevin
from tpumd_torch.md.fix_nemd import BIG, FixHeat, FixOneway, \
    FixThermalConductivity, FixViscosity, FixVector
from tpumd_torch.md.fix_nh import FixNH
from tpumd_torch.md.fix_particle import FixDeposit, FixEvaporate
from tpumd_torch.md.fix_pour import FixPour
from tpumd_torch.md.compute_styles import create_compute
from tpumd_torch.md.fix_ave import FixAveAtom, FixAveChunk, \
    FixAveCorrelate, FixAveGrid, FixAveHisto, FixAveTime, FixBalance, \
    FixHalt, FixPrint, FixPropertyAtom, FixStoreState, FixTuneKspace, \
    check_inputs
from tpumd_torch.md.fix_rigid import FixRigid, FixRigidNPH, FixRigidNPT, \
    FixRigidNVT
from tpumd_torch.md.fix_shake import FixRattle, FixShake
from tpumd_torch.md.fix_sphere import FixFreeze, FixGravity, FixNVESphere
from tpumd_torch.md.fix_wall import FixWallHarmonic, FixWallLJ126, \
    FixWallLJ93, FixWallReflect, parse_walls
from tpumd_torch.md.fix_wall_gran import FixWallGran
from tpumd_torch.md import fix_misc as fm
from tpumd_torch.md.fix_deform import NARGS, FixDeform
from tpumd_torch.md.fix_external import FixExternal
from tpumd_torch.md.fix_hyper import FixHyperGlobal
from tpumd_torch.md.fix_move import FixMove
from tpumd_torch.md.fixes import FixNVE, FixNVELimit, FixNVENoforce
from tpumd_torch.md.simulation import THERMO_KEYS, Simulation, \
    resolve_device
from tpumd_torch.models.kspace_ewald import Ewald, EwaldDisp
from tpumd_torch.models.kspace_msm import MSM
from tpumd_torch.models.kspace_pppm import PPPM, PPPMCG, PPPMStagger, \
    PPPMTIP4P
from tpumd_torch.models.kspace_pppm_disp import PPPMDisp
from tpumd_torch.models.registry import create_bonded_style, \
    create_pair_style
from tpumd_torch.utils.ranmars import RanMars
from tpumd_torch.utils.ranpark import geom_uniform_triplets
from tpumd_torch.script.formula import Formula, SimFormulaContext

BONDED_KINDS = ("bond", "angle", "dihedral", "improper")
# kspace_style name -> solver (tpumd/script/parser.py:2362-2392)
KSPACE_STYLES = {"pppm": PPPM, "pppm/cg": PPPMCG, "pppm/stagger": PPPMStagger,
                 "pppm/tip4p": PPPMTIP4P, "pppm/disp": PPPMDisp, "msm": MSM,
                 "ewald": Ewald, "ewald/disp": EwaldDisp}


class ScriptError(RuntimeError):
    pass


def _number(tok: str):
    """tok as a float, or None where it is not a number."""
    try:
        return float(tok)
    except ValueError:
        return None


class LammpsScript:
    """Parses and executes a LAMMPS input script against a Simulation on
    the given device, in the given float dtype.  Asking for CUDA on a
    machine without a card raises here.  Relative data-file and potential
    paths resolve against the deck's directory under ``run_file``, else the
    working directory.  ``var_overrides`` are the command line's ``-var``
    values: index variables that the deck's own ``variable ... index``
    lines do not overwrite."""

    def __init__(self, *, device="cuda", dtype=torch.float32,
                 var_overrides=None, mesh=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        # the process group a run is decomposed over (parallel/mesh.py);
        # every rank runs the whole script, rank 0 writes the files
        self.mesh = mesh
        self.data_dir = "."
        self.atom_style = "atomic"
        # styles named before read_data sets the type counts
        self._pending_bonded: dict = {}
        self._pending_pair = None
        self._pending_pair_modify: dict = {}
        self.sim: Simulation | None = None
        self.lattice: Lattice | None = None
        self.regions: dict[str, Region] = {}
        self.box = None
        self._atoms_x: list[np.ndarray] = []
        self._atoms_type: list[np.ndarray] = []
        # create_atoms ... mol: per command, charges, molecule ids and
        # image flags (None where it made lone atoms), and the topology of
        # the placed templates by kind
        self._atoms_q: list = []
        self._atoms_mol: list = []
        self._atoms_image: list = []
        self._topo_acc: dict = {k: [] for k in BONDED_KINDS}
        self._molid_next = 1
        self._box_tilt = None
        self._units_name = "lj"
        self.echo = False
        # name -> (style, value)
        self.variables: dict[str, tuple] = {}
        self._var_overrides = dict(var_overrides or {})
        for k, v in (var_overrides or {}).items():
            self.variables[k] = ("index", str(v))
        # script control flow (Input::file/jump, src/input.cpp)
        self._frames: list[dict] = []   # program counter stack
        self._skip_jump = False         # set when `next` exhausts a var
        self._var_lists: dict[str, tuple] = {}   # index/loop value lists
        self._atomfiles: dict[str, tuple] = {}   # name -> (sections, pos)
        self._python_funcs: dict[str, dict] = {}  # python command registry
        self._plugins: dict = {}        # plugin load: module name -> module
        # the lines executed, raw (temper replays them into each replica's
        # script), and the world this script runs as: its index picks a
        # world variable's value (-partition, or a temper replica)
        self._history: list[str] = []
        self._world_index = 0
        self.nworlds = 1
        # the library interface's error state (lammps_has_error)
        self.last_error: str | None = None
        # lammps_create_atoms: segment of _atoms_x -> (ids or None, v or
        # None)
        self._injected: dict = {}

    # -------------------------------------------------------------- plumbing
    def run_file(self, path: str):
        self.data_dir = os.path.dirname(os.path.abspath(path))
        with open(path) as fh:
            self.run_string(fh.read())

    @staticmethod
    def _to_logical(text: str):
        """Logical lines: & joins a line to the next, # starts a comment
        (also inside quotes, as tpumd cuts it; the reference keeps a
        quoted #)."""
        logical = []
        cont = ""
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip() and not cont:
                continue
            if line.endswith("&"):
                cont += line[:-1] + " "
                continue
            logical.append(cont + line)
            cont = ""
        return logical

    def run_string(self, text: str):
        self._run_program(self._to_logical(text))

    def _run_program(self, lines):
        """Program-counter-driven execution, so that jump, label and next
        can loop (Input::file, src/input.cpp)."""
        frame = {"lines": lines, "pc": 0}
        self._frames.append(frame)
        try:
            while frame["pc"] < len(frame["lines"]):
                line = frame["lines"][frame["pc"]]
                frame["pc"] += 1
                self.execute(line)
        finally:
            self._frames.pop()

    def substitute(self, line: str) -> str:
        """$x and ${name} replaced by the variables' values
        (Input::substitute, src/input.cpp)."""
        def repl(m):
            return self._var_value(m.group(1) or m.group(2))
        return re.sub(r"\$\{(\w+)\}|\$(\w)", repl, line)

    def _var_value(self, name: str) -> str:
        if name not in self.variables:
            raise ScriptError(f"Substitution for undefined variable {name!r}")
        style, value = self.variables[name]
        if style in ("equal", "internal"):
            v = float(self.evaluate_variable(name))
            return repr(int(v)) if v == int(v) else repr(v)
        if style == "world":
            return value[self._world_index]
        if style in ("format", "getenv", "python"):
            return str(self.evaluate_variable(name))
        if style == "atomfile":
            raise ScriptError(
                f"cannot substitute atomfile variable {name!r} inline")
        return value

    @staticmethod
    def _split(line: str):
        """Whitespace split honoring double-quoted groups (Input::parse)."""
        out, cur, q = [], [], False
        for ch in line:
            if ch == '"':
                q = not q
                continue
            if ch.isspace() and not q:
                if cur:
                    out.append("".join(cur))
                    cur = []
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def execute(self, line: str):
        line = line.strip()
        if not line:
            return
        self._history.append(line)
        # a fix print string is substituted when it prints, not here
        if not line.startswith("fix") or " print " not in line:
            line = self.substitute(line).strip()
        if self.echo:
            print(line, flush=True)
        args = self._split(line)
        cmd, args = args[0], args[1:]
        handler = getattr(self, "cmd_" + cmd.replace("/", "_"), None)
        if handler is None:
            self.last_error = f"Unknown command: {cmd}"
            raise NotImplementedError(
                f"command {cmd!r} is not ported to tpumd_torch")
        if cmd in self._ONE_RANK and self.mesh is not None \
                and self.mesh.distributed:
            raise NotImplementedError(
                f"command {cmd} across {self.mesh.size} ranks is not ported "
                "(ROADMAP item 14e): run it on one card")
        if cmd in self._WRITERS and not self._writer:
            return
        try:
            handler(args)
        except Exception as e:   # the library's error state (src/library.cpp
            self.last_error = str(e)   # lammps_has_error)
            raise

    # commands that run on one card only, and those whose files rank 0
    # alone writes, under a process group
    _ONE_RANK = frozenset({"temper", "neb", "prd", "tad", "hyper",
                           "minimize"})
    _WRITERS = frozenset({"log", "print"})

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _require_sim(self) -> Simulation:
        if self.sim is None:
            self.sim = Simulation(units=self._units_name, device=self.device,
                                  dtype=self.dtype, mesh=self.mesh)
        self.sim.script = self
        return self.sim

    def _path(self, name: str) -> str:
        """A file named in the deck: relative to the deck's directory."""
        return name if os.path.isabs(name) else os.path.join(self.data_dir,
                                                             name)

    # ------------------------------------------------------ variables, flow
    def cmd_variable(self, a):
        """variable name style args (src/variable.cpp Variable::set;
        tpumd/script/parser.py:191-229): index and loop keep their first
        definition (so -var values win), the others are redefined."""
        name, style = a[0], a[1]
        if style == "index":
            if name not in self.variables:
                self.variables[name] = ("index", a[2])
                self._var_lists[name] = (list(a[2:]), 0)
        elif style in ("equal", "string", "atom", "internal"):
            self.variables[name] = (style, " ".join(a[2:]))
        elif style == "world":
            self.variables[name] = ("world", a[2:])
        elif style == "loop":
            if name not in self.variables:
                n = int(a[2])
                self.variables[name] = ("index", "1")
                self._var_lists[name] = (
                    [str(i) for i in range(1, n + 1)], 0)
        elif style == "format":
            # variable x format v_src %fmt (src/variable.h FORMAT)
            self.variables[name] = ("format", (a[2].removeprefix("v_"),
                                               a[3]))
        elif style == "getenv":
            self.variables[name] = ("getenv", a[2])
        elif style == "python":
            self.variables[name] = ("python", a[2])
        elif style == "atomfile":
            self._atomfiles[name] = (self._read_atomfile(self._path(a[2])),
                                     0)
            self.variables[name] = ("atomfile", a[2])
        elif style == "delete":
            self.variables.pop(name, None)
            self._var_lists.pop(name, None)
            self._atomfiles.pop(name, None)
        else:
            raise NotImplementedError(
                f"variable style {style!r} is not ported")

    @staticmethod
    def _read_atomfile(path):
        """Every section of an atomfile variable's file (Variable::reader
        ATOMFILE, src/variable.cpp): a count line, then 'ID value' rows;
        values default to 0."""
        with open(path) as fh:
            toks = [ln.split("#", 1)[0].split() for ln in fh]
        toks = [t for t in toks if t]
        sections = []
        i = 0
        while i < len(toks):
            n = int(toks[i][0])
            sections.append({int(t[0]): float(t[1])
                             for t in toks[i + 1:i + 1 + n]})
            i += 1 + n
        return sections

    def _atomfile_values(self, name):
        """The atomfile variable's current section as an (natoms,) array
        in tag order."""
        sections, pos = self._atomfiles[name]
        self._finalize_atoms()
        n = self.sim.natoms
        out = np.zeros(n)
        for tag, val in sections[pos].items():
            if 1 <= tag <= n:
                out[tag - 1] = val
        return out

    def evaluate_variable(self, name: str):
        """A variable's value: float, (natoms,) array in tag order, or str
        (Variable::evaluate / compute_equal / compute_atom)."""
        if name not in self.variables:
            raise ScriptError(f"undefined variable {name!r}")
        style, value = self.variables[name]
        if style in ("index", "string"):
            return value
        if style == "world":
            return value[self._world_index]
        if style == "getenv":
            return os.environ.get(value, "")
        if style == "format":
            src, fmt = value
            return fmt % float(self.evaluate_variable(src))
        if style == "python":
            return self._python_call(value)
        if style == "atomfile":
            return self._atomfile_values(name)
        f = Formula(self.substitute(value))
        return f.evaluate(SimFormulaContext(self.sim, self))

    def cmd_label(self, a):
        pass

    def cmd_next(self, a):
        """next var1 [var2 ...]: advance index, loop and atomfile
        variables; an exhausted one is deleted and the next jump is
        skipped (Variable::next, src/variable.cpp)."""
        exhausted = False
        for name in a:
            if name in self._var_lists:
                vals, pos = self._var_lists[name]
                pos += 1
                if pos >= len(vals):
                    self.variables.pop(name, None)
                    self._var_lists.pop(name, None)
                    exhausted = True
                else:
                    self._var_lists[name] = (vals, pos)
                    self.variables[name] = ("index", vals[pos])
            elif name in self._atomfiles:
                secs, pos = self._atomfiles[name]
                pos += 1
                if pos >= len(secs):
                    self.variables.pop(name, None)
                    self._atomfiles.pop(name, None)
                    exhausted = True
                else:
                    self._atomfiles[name] = (secs, pos)
            else:
                raise ScriptError(f"next on non-index variable {name!r}")
        if exhausted:
            self._skip_jump = True

    def cmd_jump(self, a):
        """jump SELF|file [label] (Input::jump, src/input.cpp): the running
        frame goes on from the top of this file or another one, or from
        the label there."""
        if self._skip_jump:
            self._skip_jump = False
            return
        if not self._frames:
            raise ScriptError("jump outside a running script")
        frame = self._frames[-1]
        if a[0] != "SELF":
            with open(self._path(a[0])) as fh:
                frame["lines"] = self._to_logical(fh.read())
        # from the top of the file (the reference rewinds it; tpumd goes on
        # after a label-less jump SELF, ROADMAP C10), then to the label
        frame["pc"] = 0
        if len(a) > 1:
            for i, ln in enumerate(frame["lines"]):
                t = ln.split()
                if len(t) >= 2 and t[0] == "label" and t[1] == a[1]:
                    frame["pc"] = i
                    break
            else:
                raise ScriptError(f"label {a[1]!r} not found")

    def cmd_if(self, a):
        """if "cond" then "cmd"... [elif "cond" "cmd"...] [else "cmd"...]
        (Input::ifthenelse, src/input.cpp); a condition is a formula, or
        a string comparison where a side is not a number."""
        def truthy(cond):
            text = self.substitute(cond)
            m = re.fullmatch(r"\s*(\S+)\s*(==|!=)\s*(\S+)\s*", text)
            if m:
                lhs, op, rhs = m.groups()
                try:
                    float(lhs), float(rhs)
                except ValueError:
                    return (lhs == rhs) == (op == "==")
            ctx = SimFormulaContext(self.sim, self)
            return float(Formula(text).evaluate(ctx)) != 0

        i = 0
        taken = False
        while i < len(a):
            if i == 0 or a[i] == "elif":
                cond = a[i + 1] if a[i] == "elif" else a[0]
                j = i + (2 if a[i] == "elif" else 1)
                if a[j] == "then":
                    j += 1
                cmds = []
                while j < len(a) and a[j] not in ("elif", "else"):
                    cmds.append(a[j])
                    j += 1
                if not taken and truthy(cond):
                    taken = True
                    for c in cmds:
                        self.execute(c)
                i = j
            elif a[i] == "else":
                if not taken:
                    for c in a[i + 1:]:
                        self.execute(c)
                return
            else:
                raise ScriptError(f"if: unexpected token {a[i]!r}")

    def cmd_include(self, a):
        with open(self._path(a[0])) as fh:
            self._run_program(self._to_logical(fh.read()))

    def cmd_shell(self, a):
        """shell cd/mkdir/rm/putenv, else an external command
        (Input::shell, src/input.cpp)."""
        op = a[0]
        if op == "cd":
            os.chdir(a[1])
        elif op == "mkdir":
            for d in a[1:]:
                os.makedirs(d, exist_ok=True)
        elif op == "rm":
            for f in a[1:]:
                if os.path.exists(f):
                    os.remove(f)
        elif op == "putenv":
            for kv in a[1:]:
                k, _, v = kv.partition("=")
                os.environ[k] = v
        else:
            subprocess.run(a, check=False)

    def cmd_python(self, a):
        """python func input N args... return v_x format str
        {file f.py | here "src" | exists} (src/python.cpp): registers a
        Python function that python-style variables call."""
        fname = a[0]
        spec = {"inputs": [], "return": None, "format": None}
        src = None
        i = 1
        while i < len(a):
            k = a[i]
            if k == "input":
                n = int(a[i + 1])
                spec["inputs"] = list(a[i + 2:i + 2 + n])
                i += 2 + n
            elif k == "return":
                spec["return"] = a[i + 1].removeprefix("v_")
                i += 2
            elif k == "format":
                spec["format"] = a[i + 1]
                i += 2
            elif k == "file":
                with open(self._path(a[i + 1])) as fh:
                    src = fh.read()
                i += 2
            elif k == "here":
                src = a[i + 1]
                i += 2
            elif k == "exists":
                i += 1
            else:
                raise NotImplementedError(
                    f"python keyword {k!r} is not ported")
        ns = self._python_funcs.setdefault("_ns", {})
        if src is not None:
            exec(src, ns)
        if fname not in ns:
            raise ScriptError(f"python function {fname!r} not defined")
        spec["func"] = ns[fname]
        self._python_funcs[fname] = spec

    def _python_call(self, fname):
        spec = self._python_funcs.get(fname)
        if spec is None:
            raise ScriptError(f"python function {fname!r} not registered")
        args = []
        for tok in spec["inputs"]:
            if tok.startswith("v_"):
                args.append(self.evaluate_variable(tok[2:]))
            elif tok == "SELF":
                args.append(self)
            else:
                try:
                    args.append(float(tok) if "." in tok or "e" in tok
                                else int(tok))
                except ValueError:
                    args.append(tok)
        out = spec["func"](*args)
        fmt = spec["format"]
        if fmt:
            return {"i": int, "f": float, "s": str}.get(fmt[-1],
                                                         lambda v: v)(out)
        return out

    def cmd_print(self, a):
        print(" ".join(a).strip('"'), flush=True)

    def cmd_echo(self, a):
        """echo none|screen|log|both: screen and both print each command
        as it executes, after substitution (the port's log file gets
        thermo and run reports only)."""
        if a[0] not in ("none", "screen", "log", "both"):
            raise ScriptError(f"echo {a[0]!r}: none, screen, log or both")
        self.echo = a[0] in ("screen", "both")

    def cmd_log(self, a):
        """log file|none [append] (src/lammps.cpp:557): thermo and the
        run reports go to a new log file from here on."""
        sim = self._require_sim()
        if sim.log_fh is not None:
            sim.log_fh.close()
            sim.log_fh = None
        if a[0] != "none":
            sim.log_fh = open(self._path(a[0]),
                              "a" if "append" in a[1:] else "w")

    def cmd_timer(self, a):
        """timer full|normal|loop|off [sync|nosync] [timeout HH:MM:SS|off]
        [every N] (Timer::modify_params, src/timer.cpp:228-281): the
        timeout stops a run at a segment boundary, where the port checks
        it whatever every says; the port keeps no per-part timers, so the
        levels and sync change nothing."""
        sim = self._require_sim()
        i = 0
        while i < len(a):
            tok = a[i]
            if tok in ("full", "normal", "loop", "off", "sync", "nosync"):
                pass
            elif tok == "timeout":
                i += 1
                if a[i] in ("off", "unlimited", "-1"):
                    sim.timer_timeout = None
                else:
                    secs = 0.0
                    for p in a[i].split(":"):
                        secs = secs * 60 + float(p)
                    sim.timer_timeout = secs
            elif tok == "every":
                i += 1
            else:
                raise ScriptError(f"timer keyword {tok!r} not supported")
            i += 1

    def cmd_balance(self, a):
        """balance thresh rcb | shift dims Niter stopthresh | x|y|z
        (src/balance.cpp; tpumd/script/parser.py:2265-2284): equal-count
        spatial row blocks for the matrix engine, over the card count of
        the run's device (``parallel/balance.py``); the grid is balanced
        by construction.  Prints tpumd's line."""
        from tpumd_torch.parallel.balance import balance_atoms
        sim = self._require_sim()
        self._finalize_atoms()
        if len(a) < 2:
            raise ScriptError("balance needs thresh and a style")
        thresh, style = float(a[0]), a[1]
        if style == "rcb":
            before, after = balance_atoms(sim, "rcb")
        elif style == "shift" and len(a) > 2:
            before, after = balance_atoms(sim, "shift", dims=a[2])
        elif style in ("x", "y", "z"):
            before, after = balance_atoms(sim, "shift", dims=style)
        else:
            raise ScriptError(f"balance style {style!r} not supported")
        print(f"  rebalancing: imbalance {before:.6g} -> {after:.6g} "
              f"(threshold {thresh})", flush=True)

    def cmd_plugin(self, a):
        """plugin load file.py | list | clear (src/plugin.cpp;
        tpumd/script/parser.py:2286-2315).  A plugin is a Python file run
        as a module: its code registers styles with
        ``tpumd_torch.models.registry`` (``register_pair``,
        ``register_bonded``), after which a deck names them like the
        built-in ones; ``__tpumd_styles__`` lists them.  Registrations
        stay for the session, as tpumd's do: clear forgets the modules."""
        if a[0] == "load" and len(a) == 2:
            import importlib.util
            path = self._path(a[1])
            name = "tpumd_plugin_" + os.path.splitext(
                os.path.basename(path))[0]
            spec = importlib.util.spec_from_file_location(name, path)
            if spec is None or not os.path.exists(path):
                raise ScriptError(f"plugin load: no file {path!r}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._plugins[name] = mod
            n = len(getattr(mod, "__tpumd_styles__", ())) or "?"
            print(f"Loaded plugin {os.path.basename(path)}: {n} styles")
        elif a == ["list"]:
            for name, mod in self._plugins.items():
                print(f"plugin {name}: "
                      + " ".join(getattr(mod, "__tpumd_styles__", ())))
        elif a[0] in ("clear", "unload"):
            self._plugins.clear()
        else:
            raise ScriptError(f"plugin {' '.join(a)}: load file, list or "
                              "clear")

    def cmd_info(self, a):
        """info [system|groups|styles|fixes|computes|variables|all ...]
        (src/info.cpp categories, to the screen)."""
        from tpumd_torch.models import registry
        cats = [t for t in a if t not in ("out", "screen", "log")] \
            or ["system"]
        if "all" in cats:
            cats = ["system", "groups", "styles", "fixes", "computes",
                    "variables"]
        sim = self.sim
        for cat in cats:
            print(f"Info-Info-Info: {cat}")
            if cat == "system" and sim is not None:
                print(f"units = {sim.units.name}")
                print(f"atom_style = {self.atom_style}")
                print(f"natoms = {sim.natoms}  ntypes = {sim.ntypes}  "
                      f"step = {sim.step}")
                if sim.state is not None:
                    lo = sim.state.box.lo.cpu().numpy()
                    hi = sim.state.box.hi.cpu().numpy()
                    per = "".join("p" if p else "f"
                                  for p in sim.state.box.periodic)
                    print(f"box = ({lo[0]:g} {lo[1]:g} {lo[2]:g}) to "
                          f"({hi[0]:g} {hi[1]:g} {hi[2]:g})  boundary {per}")
                if sim.pair is not None:
                    print(f"pair_style = {sim.pair.name}")
                if sim.kspace is not None:
                    print(f"kspace_style = {type(sim.kspace).__name__}")
            elif cat == "groups" and sim is not None:
                for name, bit in sim.groups.items():
                    print(f"group {name} bit {bit}")
            elif cat == "styles":
                create_pair_style("lj/cut", 1, [1.0])   # registers them
                create_bonded_style("bond", "harmonic", (), 1)
                print("pair styles:", " ".join(sorted(registry._PAIR_STYLES)))
                for kind, table in registry._BONDED_STYLES.items():
                    print(f"{kind} styles:", " ".join(sorted(table)))
            elif cat == "fixes" and sim is not None:
                for fx in sim.fixes:
                    print(f"fix {fx.id} style {fx.name}")
            elif cat == "computes" and sim is not None:
                for cid, comp in sim.computes.items():
                    print(f"compute {cid} style {type(comp).__name__}")
            elif cat == "variables":
                for name, (style, val) in self.variables.items():
                    print(f"variable {name} style {style} = {val}")

    # -------------------------------------------------------------- commands
    def cmd_units(self, a):
        self._units_name = a[0]
        old = self.sim
        self.sim = Simulation(units=a[0], device=self.device,
                              dtype=self.dtype, mesh=self.mesh)
        self.sim.script = self
        if old is not None:
            # a boundary or dimension command may come first
            self.sim.boundary, self.sim.dimension = old.boundary, \
                old.dimension

    def cmd_atom_style(self, a):
        get_style(a[0])   # raises for a style the port does not have
        self.atom_style = a[0]

    def cmd_boundary(self, a):
        """Per axis p, or a face pair of f (fixed), s (shrink-wrapped) and
        m (shrink-wrapped with a minimum) (tpumd/script/parser.py:491)."""
        if len(a) != 3 or any(len(t) > 2 or set(t) - set("pfsm")
                              or ("p" in t and t != "p") for t in a):
            raise ScriptError(f"boundary {' '.join(a)} is not a boundary")
        if self.box is not None or (self.sim is not None
                                    and self.sim.state is not None):
            raise ScriptError("boundary command after the simulation box "
                              "is defined")
        self._require_sim().boundary = tuple(a)

    def cmd_newton(self, a):
        pass   # every sweep sums both sides of a pair on its own atom

    def cmd_comm_modify(self, a):
        pass   # no ghost atoms: partners' velocities are read in place

    def cmd_read_data(self, a):
        path = a[0]
        if not os.path.isabs(path):
            path = os.path.join(self.data_dir, path)
        sim = self._require_sim()
        self._box_keywords(sim, a[1:], "read_data")
        d = read_data(path, self.atom_style)
        sim.ntypes = d.natomtypes
        sim.mass = d.masses.copy()
        # the reference remaps every read atom into the box
        # (src/atom.cpp:1176 -> Domain::remap) and folds the shift into
        # the image flags
        periodic = tuple(t == "p" for t in sim.boundary)
        x = np.ascontiguousarray(d.x, dtype=np.float64)
        if d.tilt is not None and np.any(d.tilt != 0):
            # a triclinic box remaps through lamda space, as the reference
            # does; the round trip moves coordinates by an ulp, which the
            # loop-geom velocity hash sees
            x, shift = remap_triclinic_host(x, d.box_lo, d.box_hi, d.tilt,
                                            periodic)
            image = d.image + shift
            box = Box.triclinic(d.box_lo, d.box_hi, d.tilt,
                                device=sim.device, dtype=self.dtype,
                                periodic=periodic)
        else:
            image = d.image + remap_host(x, d.box_lo, d.box_hi, periodic)
            box = Box.orthogonal(d.box_lo, d.box_hi, device=sim.device,
                                 dtype=self.dtype, periodic=periodic)
        sim.state = make_state(x, d.v, d.types, box, image=image,
                               molecule=d.molecule, q=d.q, radius=d.radius,
                               rmass=d.rmass, omega=d.omega, extras=d.fields,
                               device=sim.device, dtype=self.dtype)
        sim.topology = {}
        for kind in BONDED_KINDS:
            arr = getattr(d, kind + "s")
            sim.bonded_ntypes[kind] = getattr(d, f"n{kind}types")
            if arr is not None and len(arr):
                sim.topology[kind] = arr
        sim.special_tags = sim.special_codes = None
        if d.bonds is not None and len(d.bonds):
            sim.special_tags, sim.special_codes = build_special(
                d.natoms, d.bonds)
        self._materialize_styles()
        # coefficient sections of the data file
        # (tpumd/script/parser.py:2495-2503: Pair Coeffs read before any
        # pair_style are dropped, where LAMMPS stops with an error; a
        # style without its own reader takes each row as pair_coeff t t)
        if "Pair Coeffs" in d.coeffs and sim.pair is not None:
            if hasattr(sim.pair, "coeff_from_data"):
                sim.pair.coeff_from_data(d.coeffs["Pair Coeffs"])
            else:
                for r in d.coeffs["Pair Coeffs"]:
                    t = int(r[0])
                    sim.pair.coeff(t, t, t, t, *[float(v) for v in r[1:]])
        for kind in BONDED_KINDS:
            rows = d.coeffs.get(kind.capitalize() + " Coeffs")
            if rows is not None and kind in sim.bonded:
                for r in rows:
                    sim.bonded[kind].coeff(
                        int(r[0]), *[self.coeff_token(v) for v in r[1:]])

    def _materialize_styles(self):
        """Make the styles named before read_data (src/input.cpp defers
        nothing; the port needs the type counts first)."""
        sim = self.sim
        if self._pending_pair is not None:
            name, args = self._pending_pair
            sim.pair = create_pair_style(name, sim.ntypes, args,
                                         units=sim.units)
            self._pending_pair = None
            self._apply_pair_modify(self._pending_pair_modify)
            self._pending_pair_modify = {}
        for kind, (name, args) in self._pending_bonded.items():
            self._add_bonded(kind, name, args)
        self._pending_bonded = {}

    def _add_bonded(self, kind, name, args):
        sim = self.sim
        sim.bonded[kind] = create_bonded_style(
            kind, name, args, sim.bonded_ntypes.get(kind, 0))

    def _bonded_style(self, kind, a):
        sim = self._require_sim()
        if a[0] == "none":
            sim.bonded.pop(kind, None)
            self._pending_bonded.pop(kind, None)
            return
        create_bonded_style(kind, a[0], a[1:], 0)  # raises if not ported
        if kind not in sim.bonded_ntypes:
            # before read_data: defer
            self._pending_bonded[kind] = (a[0], tuple(a[1:]))
        else:
            self._add_bonded(kind, a[0], a[1:])

    def coeff_token(self, tok):
        """A bonded coefficient as its style reads it: a number, or a
        string (a hybrid sub-style, a class2 keyword, a table file, which
        resolves against the deck's directory, or a table keyword)
        (tpumd/script/parser.py::_bonded_coeff)."""
        try:
            return float(tok)
        except ValueError:
            path = os.path.join(self.data_dir, tok)
            if not os.path.exists(tok) and os.path.exists(path):
                return path
            return tok

    def _bonded_coeff(self, kind, a):
        if self.sim is None or kind not in self.sim.bonded:
            raise ScriptError(f"{kind}_coeff before {kind}_style")
        self.sim.bonded[kind].coeff(int(a[0]),
                                    *[self.coeff_token(v) for v in a[1:]])

    def cmd_bond_style(self, a):
        self._bonded_style("bond", a)

    def cmd_angle_style(self, a):
        self._bonded_style("angle", a)

    def cmd_dihedral_style(self, a):
        self._bonded_style("dihedral", a)

    def cmd_improper_style(self, a):
        self._bonded_style("improper", a)

    def cmd_bond_coeff(self, a):
        self._bonded_coeff("bond", a)

    def cmd_angle_coeff(self, a):
        self._bonded_coeff("angle", a)

    def cmd_dihedral_coeff(self, a):
        self._bonded_coeff("dihedral", a)

    def cmd_improper_coeff(self, a):
        self._bonded_coeff("improper", a)

    # special_bonds presets: the 1-2, 1-3, 1-4 (lj, coul) weights
    # (src/special.cpp, tpumd/script/parser.py:2683)
    _SPECIAL_BONDS = {"fene": ((0.0, 1.0, 1.0), (0.0, 1.0, 1.0)),
                      "charmm": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                      "amber": ((0.0, 0.0, 0.5), (0.0, 0.0, 1.0 / 1.2))}

    def cmd_special_bonds(self, a):
        if a[0] == "lj/coul" and len(a) == 4:
            w = tuple(float(v) for v in a[1:4])
            wl = wc = w
        elif a[0] in self._SPECIAL_BONDS and len(a) == 1:
            wl, wc = self._SPECIAL_BONDS[a[0]]
        else:
            raise NotImplementedError(
                f"special_bonds {' '.join(a)} is not ported")
        sim = self._require_sim()
        sim.special_lj = np.array((1.0,) + wl)
        sim.special_coul = np.array((1.0,) + wc)
        sim.invalidate_ctx()

    def cmd_kspace_style(self, a):
        """kspace_style pppm|pppm/cg|pppm/stagger|pppm/tip4p|pppm/disp|msm|
        ewald|ewald/disp accuracy, pppm/cg with an optional smallq, or none
        (tpumd/script/parser.py:2362-2392)."""
        sim = self._require_sim()
        if a and a[0] == "none" and len(a) == 1:
            sim.kspace = None
        elif a and a[0] in KSPACE_STYLES and len(a) in (
                (2, 3) if a[0] == "pppm/cg" else (2,)):
            sim.kspace = KSPACE_STYLES[a[0]](*[float(v) for v in a[1:]])
        else:
            raise NotImplementedError(
                f"kspace_style {' '.join(a)} is not ported (one of "
                f"{', '.join(KSPACE_STYLES)} with an accuracy, or none)")
        sim.invalidate_ctx()

    def cmd_kspace_modify(self, a):
        """kspace_modify keyword value ... with tpumd's keys
        (tpumd/script/parser.py:2394-2431): diff ad|ik, mesh nx ny nz,
        order n, gewald g, disp/auto yes|no, mesh/disp nx ny nz, order/disp
        n, gewald/disp g.  gewald under ewald or ewald/disp raises: tpumd's
        Ewald drops it without a word (ROADMAP C21)."""
        sim = self._require_sim()
        ks = sim.kspace
        if ks is None:
            raise ScriptError("kspace_modify before kspace_style")
        nvals = {"diff": 1, "mesh": 3, "order": 1, "gewald": 1,
                 "disp/auto": 1, "mesh/disp": 3, "order/disp": 1,
                 "gewald/disp": 1}
        disp = ("disp/auto", "mesh/disp", "order/disp", "gewald/disp")
        i = 0
        while i < len(a):
            key = a[i]
            if key not in nvals or i + nvals[key] >= len(a):
                raise NotImplementedError(
                    f"kspace_modify {' '.join(a[i:])}: not ported (the keys "
                    f"{', '.join(nvals)} with their values)")
            vals = a[i + 1:i + 1 + nvals[key]]
            if key in disp and ks.style != "pppm/disp":
                raise NotImplementedError(
                    f"kspace_modify {key} under kspace_style {ks.style}: "
                    "only pppm/disp reads it")
            if key == "diff":
                if vals[0] not in ("ad", "ik"):
                    raise ScriptError(f"kspace_modify diff {vals[0]}")
                ks.mode = vals[0]
            elif key == "mesh":
                ks.mesh_override = tuple(int(v) for v in vals)
            elif key == "order":
                ks.order = int(vals[0])
            elif key == "gewald":
                if ks.style.startswith("ewald"):
                    raise NotImplementedError(
                        f"kspace_modify gewald under kspace_style "
                        f"{ks.style}: tpumd's Ewald ignores it without a "
                        "word, so neither tpumd's numbers nor LAMMPS's can "
                        "be met (ROADMAP C21)")
                ks.gewald_override = float(vals[0])
            elif key == "disp/auto":
                ks.disp_auto = vals[0] == "yes"
            elif key == "mesh/disp":
                ks.mesh6_override = tuple(int(v) for v in vals)
            elif key == "order/disp":
                ks.order_6 = int(vals[0])
            else:
                ks.gewald6_override = float(vals[0])
            i += 1 + nvals[key]
        sim.invalidate_ctx()

    def cmd_replicate(self, a):
        """Tile the system nx x ny x nz (src/replicate.cpp, tpumd/script/
        parser.py:2622-2681): atoms unwrapped by their image flags and
        shifted by box images, then tags, molecules, topology and special
        tags offset per replica."""
        if len(a) != 3:
            raise NotImplementedError(f"replicate keywords {a[3:]} are not "
                                      "ported")
        nx, ny, nz = (int(v) for v in a)
        if (nx, ny, nz) == (1, 1, 1):
            return
        sim = self.sim
        if sim.state.box.istriclinic:
            raise NotImplementedError("replicate of a triclinic box is not "
                                      "ported")
        sim.invalidate_ctx()   # back to natoms rows after an earlier run
        # rows in tag order: replica r's atom k takes tag k + r n
        order = torch.argsort(sim.state.tag)
        s = map_per_atom(sim.state, lambda t: t[order])
        n = sim.natoms
        lo = s.box.lo.cpu().numpy().astype(np.float64)
        ell = s.box.lengths_np()
        x = s.x.cpu().numpy().astype(np.float64) \
            + s.image.cpu().numpy() * ell
        v = s.v.cpu().numpy().astype(np.float64)
        reps = [(i, j, k) for k in range(nz) for j in range(ny)
                for i in range(nx)]
        nrep = len(reps)
        xs = np.concatenate([x + np.array(r) * ell for r in reps])
        mol = None if s.molecule is None else s.molecule.cpu().numpy()
        maxmol = int(mol.max()) if mol is not None and len(mol) else 0
        box = Box.orthogonal(lo, lo + ell * np.array([nx, ny, nz]),
                             device=sim.device, dtype=self.dtype,
                             periodic=s.box.periodic)
        sim.state = make_state(
            xs, np.tile(v, (nrep, 1)), np.tile(s.type.cpu().numpy(), nrep),
            box, molecule=None if mol is None else np.concatenate(
                [mol + r * maxmol for r in range(nrep)]),
            q=None if s.q is None else np.tile(
                s.q.cpu().numpy().astype(np.float64), nrep),
            device=sim.device, dtype=self.dtype)
        sim._natoms = None
        for kind, arr in sim.topology.items():
            out = []
            for r in range(nrep):
                rep = arr.copy()
                rep[:, 1:] += r * n
                out.append(rep)
            sim.topology[kind] = np.concatenate(out)
        if sim.special_tags is not None:
            st = sim.special_tags
            sim.special_tags = np.concatenate(
                [np.where(st > 0, st + r * n, 0) for r in range(nrep)])
            sim.special_codes = np.tile(sim.special_codes, (nrep, 1))
        sim.invalidate_ctx()

    def cmd_lattice(self, a):
        sim = self._require_sim()
        self.lattice = Lattice(a[0], float(a[1]), units=sim.units.name,
                               dimension=sim.dimension, args=a[2:])

    # values each region style takes before its keywords (union and
    # intersect: N and N names)
    _REGION_NARGS = {"block": 6, "prism": 9, "sphere": 4, "cylinder": 6,
                     "cone": 7, "plane": 6, "ellipsoid": 6}

    def cmd_region(self, a):
        """region ID style args [side in|out] [units box|lattice]
        (src/region.cpp, tpumd/script/parser.py:513-635): every style of
        core/region.py.  Lengths are in lattice spacings by default when
        a lattice exists; a cylinder's or cone's centre and radii take the
        spacings of the axes across it, its bounds the axis's.  INF and
        EDGE open a lo bound toward -infinity and a hi bound toward
        +infinity (atoms are inside the box, so EDGE selects as INF does,
        as in tpumd)."""
        name, style = a[0], a[1]
        if style in ("union", "intersect"):
            nval = 1 + int(a[2])
        elif style in self._REGION_NARGS:
            nval = self._REGION_NARGS[style]
        else:
            raise NotImplementedError(f"region style {style!r} is not ported")
        vals, rest = a[2:2 + nval], a[2 + nval:]
        kw = dict(zip(rest[::2], rest[1::2]))
        if (len(rest) % 2 or set(kw) - {"side", "units"}
                or kw.get("side", "in") not in ("in", "out")
                or kw.get("units", "lattice") not in ("box", "lattice")):
            raise NotImplementedError(
                f"region keywords {rest} are not ported (only side in|out "
                "and units box|lattice)")
        sp = (np.asarray(self.lattice.spacing, np.float64)
              if self.lattice is not None and kw.get("units") != "box"
              else np.ones(3))

        def bound(tok, k, scale):
            if tok in ("INF", "EDGE"):
                return -np.inf if k == 0 else np.inf
            return float(tok) * scale

        if style in ("block", "prism"):
            lo = [bound(vals[2 * c], 0, sp[c]) for c in range(3)]
            hi = [bound(vals[2 * c + 1], 1, sp[c]) for c in range(3)]
            if style == "block":
                region = BlockRegion(lo, hi)
            else:
                # xy moves x per unit y, xz and yz likewise
                # (region_prism.cpp scaling)
                tilt = [float(vals[6]) * sp[0], float(vals[7]) * sp[0],
                        float(vals[8]) * sp[1]]
                region = PrismRegion(lo, hi, tilt)
        elif style == "sphere":
            v = [float(t) for t in vals]
            region = SphereRegion(np.array(v[:3]) * sp, v[3] * sp[0])
        elif style in ("cylinder", "cone"):
            dim = "xyz".index(vals[0])
            o1, o2 = [c for c in range(3) if c != dim]
            radii = [float(t) * sp[o1] for t in vals[3:-2]]
            lo_hi = (bound(vals[-2], 0, sp[dim]), bound(vals[-1], 1, sp[dim]))
            centre = (float(vals[1]) * sp[o1], float(vals[2]) * sp[o2])
            region = (CylinderRegion(dim, *centre, *radii, *lo_hi)
                      if style == "cylinder"
                      else ConeRegion(dim, *centre, *radii, *lo_hi))
        elif style == "plane":
            region = PlaneRegion(np.array([float(t) for t in vals[:3]]) * sp,
                                 [float(t) for t in vals[3:]])
        elif style == "ellipsoid":
            v = np.array([float(t) for t in vals])
            region = EllipsoidRegion(v[:3] * sp, v[3:] * sp)
        else:
            missing = [r for r in vals[1:] if r not in self.regions]
            if missing:
                raise ScriptError(f"region {style}: undefined regions "
                                  f"{missing}")
            subs = [self.regions[r] for r in vals[1:]]
            region = (UnionRegion(subs) if style == "union"
                      else IntersectRegion(subs))
        if kw.get("side") == "out":
            region = OutsideRegion(region)
        self.regions[name] = region

    def cmd_create_box(self, a):
        """create_box N region [bond/types N ...] [extra/.../per/atom N]
        (src/create_box.cpp; tpumd/script/parser.py:637-658): the box is
        the region's bounding box, tilted where the region is a prism with
        tilt (a triclinic box, as read_data makes one); the bonded type
        counts let the bonded styles be made at once, and the extra
        per-atom counts give created bonds their room (fix bond/create)."""
        ntypes = int(a[0])
        region = self.regions[a[1]]
        self.box = region.bounding_box()
        self._box_tilt = None
        if isinstance(region, PrismRegion) and np.any(region.tilt != 0):
            self._box_tilt = np.asarray(region.tilt, np.float64)
        sim = self._require_sim()
        sim.ntypes = ntypes
        sim.mass = np.zeros(ntypes + 1)
        self._box_keywords(sim, a[2:], "create_box")
        self._materialize_styles()

    @staticmethod
    def _box_keywords(sim, rest, cmd):
        """The bonded type counts and extra per-atom counts of create_box
        (and the extra counts of read_data)."""
        if len(rest) % 2:
            raise ScriptError(f"{cmd}: odd keyword list {rest}")
        for key, val in zip(rest[::2], rest[1::2]):
            kind = key.split("/")[0]
            if cmd == "create_box" and kind in BONDED_KINDS \
                    and key == f"{kind}/types":
                sim.bonded_ntypes[kind] = int(val)
            elif key.startswith("extra/") and key.endswith("/per/atom") \
                    and key.split("/")[1] in BONDED_KINDS + ("special",):
                sim.extra_per_atom[key.split("/")[1]] = int(val)
            else:
                raise NotImplementedError(
                    f"{cmd} keyword {key} is not ported (only "
                    + ("bond|angle|dihedral|improper/types and "
                       if cmd == "create_box" else "")
                    + "extra/.../per/atom)")

    def cmd_molecule(self, a):
        """molecule ID file (src/molecule.cpp): a template for create_atoms
        ... mol; keywords raise."""
        if len(a) != 2:
            raise NotImplementedError(
                f"molecule keywords {a[2:]} are not ported")
        self._require_sim().molecules[a[0]] = MoleculeTemplate(
            a[0], self._path(a[1]))

    def cmd_create_atoms(self, a):
        """create_atoms type box | region ID [mol ID seed]
        (src/create_atoms.cpp; tpumd/script/parser.py:659-740).  With a
        molecule template, one copy sits at each lattice site, turned by a
        random rotation drawn in site order (CreateAtoms::add_molecule,
        src/create_atoms.cpp:1376-1394: three uniforms for the axis, one
        for the angle), its types offset by type, remapped into the box,
        and its topology appended with the copy's tags."""
        type_id, style = int(a[0]), a[1]
        lo, hi = self.box
        npos = {"box": 2, "region": 3}.get(style)
        rest = a[npos:] if npos else []
        if npos is None or len(a) < npos or rest not in (
                [], ["mol"] + rest[1:3]) or len(rest) not in (0, 3):
            raise NotImplementedError(
                f"create_atoms {' '.join(a[1:])!r} is not ported")
        region = self.regions[a[2]] if style == "region" else None
        x, t = create_atoms_lattice(self.lattice, region, lo, hi, type_id,
                                    fill_box=region is None)
        if not rest:
            self._append_atoms(x, t)
            return
        mol = self._require_sim().molecules[rest[1]]
        rng = RanMars(int(rest[2]))
        nm = mol.natoms
        tag0 = sum(len(xa) for xa in self._atoms_x)
        coords = np.empty((len(x) * nm, 3), np.float64)
        for k, site in enumerate(x):
            r = norm3_np(np.array([rng.uniform() - 0.5 for _ in range(3)]))
            theta = rng.uniform() * 2.0 * np.pi
            coords[k * nm:(k + 1) * nm] = rotate_place_np(
                mol.dx, quat_to_mat_np(axisangle_to_quat(r, theta)), site)
        # the reference remaps every created atom at the end of the
        # command (src/create_atoms.cpp:617 -> Domain::remap); velocity
        # loop geom hashes the stored coordinates
        img = remap_host(coords, np.asarray(lo, np.float64),
                         np.asarray(hi, np.float64),
                         tuple(tok == "p" for tok in self.sim.boundary))
        types = np.tile(np.asarray(mol.types, np.int32) + type_id, len(x))
        q = np.tile(mol.q if mol.q is not None else np.zeros(nm), len(x))
        molid = np.repeat(np.arange(self._molid_next,
                                    self._molid_next + len(x)), nm)
        self._molid_next += len(x)
        self._append_atoms(coords, types, q=q, mol=molid, image=img)
        for kind in BONDED_KINDS:
            arr = getattr(mol, kind + "s")
            if len(arr):
                per = np.tile(arr, (len(x), 1))
                per[:, 1:] += (np.repeat(np.arange(len(x)) * nm,
                                         len(arr))[:, None] + tag0)
                self._topo_acc[kind].append(per)

    def _append_atoms(self, x, t, q=None, mol=None, image=None):
        self._atoms_x.append(x)
        self._atoms_type.append(t)
        self._atoms_q.append(q)
        self._atoms_mol.append(mol)
        self._atoms_image.append(image)

    def cmd_mass(self, a):
        sim = self._require_sim()
        if a[0] == "*":
            sim.mass[1:] = float(a[1])
        else:
            sim.mass[int(a[0])] = float(a[1])

    def _finalize_atoms(self):
        """The state from the atoms that create_atoms made; atom_style
        sphere gives each diameter 1 and density 1, so mass pi/6
        (AtomVecSphere::create_atom, src/atom_vec_sphere.cpp;
        tpumd/script/parser.py:856-863).  A tilted create_box region
        makes a triclinic box; molecule templates bring charges, molecule
        ids, image flags, and the topology and its special lists."""
        sim = self.sim
        if sim.state is None:
            x = np.concatenate(self._atoms_x)
            t = np.concatenate(self._atoms_type)
            lo, hi = self.box
            periodic = tuple(tk == "p" for tk in sim.boundary)
            if self._box_tilt is not None:
                box = Box.triclinic(lo, hi, self._box_tilt,
                                    device=sim.device, dtype=self.dtype,
                                    periodic=periodic)
            else:
                box = Box.orthogonal(lo, hi, device=sim.device,
                                     dtype=self.dtype, periodic=periodic)

            def joined(segs, dtype, width=None):
                # per-command segments, zeros where a command gave none
                if all(sg is None for sg in segs):
                    return None
                return np.concatenate([
                    np.zeros((len(xa),) + ((width,) if width else ()), dtype)
                    if sg is None else np.asarray(sg, dtype)
                    for sg, xa in zip(segs, self._atoms_x)])
            radius = rmass = None
            if self.atom_style == "sphere":
                radius = np.full(len(x), 0.5)
                rmass = 4.0 / 3.0 * np.pi * radius**3
            q = joined(self._atoms_q, np.float64)
            if q is None and self.atom_style in ("charge", "full"):
                q = np.zeros(len(x))
            mol = joined(self._atoms_mol, np.int32)
            if mol is None and self.atom_style in (
                    "bond", "angle", "molecular", "full"):
                mol = np.zeros(len(x), np.int32)
            tags, v = self._injected_arrays(len(x))
            sim.state = make_state(x, np.zeros_like(x) if v is None else v,
                                   t, box, q=q, tags=tags, molecule=mol,
                                   image=joined(self._atoms_image, np.int32,
                                                3),
                                   radius=radius, rmass=rmass,
                                   device=sim.device, dtype=self.dtype)
            for kind, chunks in self._topo_acc.items():
                if chunks:
                    arr = np.concatenate(chunks)
                    sim.topology[kind] = arr
                    sim.bonded_ntypes[kind] = max(
                        sim.bonded_ntypes.get(kind, 0),
                        int(arr[:, 0].max()))
            if "bond" in sim.topology:
                sim.special_tags, sim.special_codes = build_special(
                    len(x), sim.topology["bond"])

    def _atom_masses(self) -> np.ndarray:
        """(N,) f64 per-atom masses: rmass for spheres, else by type."""
        s = self.sim.state
        if s.rmass is not None:
            return s.rmass.cpu().numpy().astype(np.float64)
        return self.sim.mass[s.type.cpu().numpy()]

    # the keywords of each velocity style that the port takes (of
    # src/velocity.cpp::options; temp, bias and rigid are not ported)
    _VELOCITY_KEYS = {"create": {"dist", "sum", "mom", "rot", "loop",
                                 "units"},
                      "set": {"sum", "units"}, "scale": set(),
                      "ramp": {"sum", "units"}, "zero": set()}

    def cmd_velocity(self, a):
        """velocity group create|set|scale|ramp|zero ... (src/velocity.cpp,
        tpumd/script/parser.py:913-1011).  create takes group all with
        loop geom (dist uniform|gaussian, mom, rot, sum); set and ramp
        take lengths in lattice spacings unless units box, and sum; scale
        uses the group's temperature with dim (n - 1) degrees of freedom;
        zero linear|angular removes the group's centre-of-mass motion or
        rigid rotation."""
        self._finalize_atoms()
        sim = self.sim
        group, style = a[0], a[1]
        npos = {"create": 2, "set": 3, "scale": 1, "ramp": 6, "zero": 1}
        if style not in npos:
            raise NotImplementedError(f"velocity style {style!r} is not "
                                      "ported")
        pos, rest = a[2:2 + npos[style]], a[2 + npos[style]:]
        kw = dict(zip(rest[::2], rest[1::2]))
        unknown = set(kw) - self._VELOCITY_KEYS[style]
        if len(rest) % 2 or unknown:
            raise NotImplementedError(
                f"velocity {style} keywords {rest} are not ported")
        s = sim.state
        sel = self._select("group", group)
        v = s.v.cpu().numpy().astype(np.float64)
        masses = self._atom_masses()
        sum_ = kw.get("sum", "no") == "yes"
        scale = (np.asarray(self.lattice.spacing, np.float64)
                 if self.lattice is not None
                 and kw.get("units", "lattice") == "lattice" else np.ones(3))
        u = sim.units
        if style == "set":
            v = velocity_set(v, sel, [None if t == "NULL" else float(t)
                                      for t in pos], scale, sum_)
        elif style == "scale":
            v = velocity_scale(v, masses, sel, float(pos[0]), sim.dimension,
                               u.mvv2e, u.boltz)
        elif style == "ramp":
            vdim, cdim = "xyz".index(pos[0][1]), "xyz".index(pos[3])
            v = velocity_ramp(v, s.x.cpu().numpy().astype(np.float64), sel,
                              vdim, float(pos[1]) * scale[vdim],
                              float(pos[2]) * scale[vdim], cdim,
                              float(pos[4]) * scale[cdim],
                              float(pos[5]) * scale[cdim], sum_)
        elif style == "zero":
            if pos[0] == "linear":
                v = zero_momentum(v, masses, sel)
            elif pos[0] == "angular":
                v = zero_rotation(v, self._unwrapped(), masses, sel)
            else:
                raise ScriptError(f"velocity zero {pos[0]}: linear or "
                                  "angular")
        else:
            if group != "all":
                raise NotImplementedError(
                    f"velocity {group} create: only group all is ported")
            if kw.get("loop", "all") != "geom":
                raise NotImplementedError(
                    "only 'loop geom' velocity creation is ported")
            # the hash reads the positions as stored, in the run's dtype
            x = s.x.cpu().numpy().astype(np.float64)
            sim.build_shake()   # SHAKE's removed dof enter the scaling
            fix_dof = sum(fx.dof_removed for fx in sim.fixes)
            vnew = velocity_create_geom(
                x, masses, float(pos[0]), int(pos[1]),
                boltz=u.boltz, mvv2e=u.mvv2e,
                dist=kw.get("dist", "uniform"),
                zero_momentum=kw.get("mom", "yes") == "yes",
                dimension=sim.dimension,
                extra_dof=sim.dimension + fix_dof,
                rot_xu=(self._unwrapped() if kw.get("rot", "no") == "yes"
                        else None))
            v = v + vnew if sum_ else vnew
        sim.state = s.replace(
            v=torch.as_tensor(v, dtype=self.dtype, device=sim.device))

    def _unwrapped(self) -> np.ndarray:
        """(N, 3) f64 positions unwrapped by their image flags."""
        s = self.sim.state
        return (s.x.cpu().numpy().astype(np.float64)
                + s.image.cpu().numpy() * s.box.lengths_np())

    def cmd_pair_style(self, a):
        sim = self._require_sim()
        if sim.ntypes == 0:
            # before create_box or read_data: made once the types are known
            create_pair_style(a[0], 1, a[1:])   # raises if not ported
            self._pending_pair = (a[0], a[1:])
            sim.pair = None
        else:
            sim.pair = create_pair_style(a[0], sim.ntypes, a[1:],
                                         units=sim.units)

    def cmd_pair_coeff(self, a):
        sim = self.sim

        def parse_range(tok, n):
            if tok == "*":
                return 1, n
            if tok.endswith("*"):
                return int(tok[:-1]), n
            if tok.startswith("*"):
                return 1, int(tok[1:])
            return int(tok), int(tok)

        ilo, ihi = parse_range(a[0], sim.ntypes)
        jlo, jhi = parse_range(a[1], sim.ntypes)
        # numbers, else a potential file (relative paths resolve against
        # the deck's directory where the file is found there) or an
        # element name
        rest = []
        for tok in a[2:]:
            try:
                rest.append(float(tok))
            except ValueError:
                path = os.path.join(self.data_dir, tok)
                rest.append(path if not os.path.isabs(tok)
                            and os.path.exists(path) else tok)
        sim.pair.coeff(ilo, ihi, jlo, jhi, *rest)
        # potentials that carry per-type masses (EAM files) set them, as
        # the reference does: in.eam has no mass command
        pmass = getattr(sim.pair, "mass", None)
        if pmass is not None:
            nz = np.nonzero(pmass)[0]
            sim.mass[nz] = pmass[nz]

    def cmd_pair_modify(self, a):
        kw = dict(zip(a[::2], a[1::2]))
        if self.sim.pair is None:
            self._pending_pair_modify.update(kw)
            return
        self._apply_pair_modify(kw)

    def _apply_pair_modify(self, kw):
        pair = self.sim.pair
        for key, val in kw.items():
            if key == "shift":
                pair.shift = val == "yes"
            elif key == "mix":
                pair.mix = val
            elif key == "tail":
                pair.tail_flag = val == "yes"
            else:
                raise NotImplementedError(f"pair_modify {key} is not ported")
        self.sim.invalidate_ctx()

    def cmd_neighbor(self, a):
        sim = self._require_sim()
        sim.skin = float(a[0])
        if a[1] != "bin":
            raise NotImplementedError(f"neighbor style {a[1]!r} is not ported")

    def cmd_neigh_modify(self, a):
        sim = self._require_sim()
        if a and a[0] == "exclude":
            return self._neigh_exclude(a)
        for key, val in zip(a[::2], a[1::2]):
            if key == "delay":
                sim.neigh_delay = int(val)
            elif key == "every":
                sim.neigh_every = int(val)
            elif key == "check":
                sim.neigh_check = val == "yes"
            else:
                raise NotImplementedError(
                    f"neigh_modify {key} is not ported")
        if len(a) % 2:
            raise ScriptError(f"neigh_modify: odd argument list {a}")
        sim.invalidate_ctx()

    def _neigh_exclude(self, a):
        """neigh_modify exclude group g1 g2 (src/neighbor.cpp exclusion
        lists, tpumd/script/parser.py:1102-1110): pairs of a g1 and a g2
        atom are never in contact."""
        sim = self.sim
        if len(a) != 4 or a[1] != "group":
            raise NotImplementedError(
                f"neigh_modify {' '.join(a)} is not ported (only exclude "
                "group g1 g2)")
        sim.neigh_exclude += ((self._group_bit(a[2]), self._group_bit(a[3])),)
        sim.invalidate_ctx()

    def cmd_timestep(self, a):
        self._require_sim().dt = float(a[0])
        self.sim.invalidate_ctx()

    def cmd_thermo(self, a):
        self._require_sim().thermo_every = int(a[0])

    def cmd_thermo_style(self, a):
        sim = self._require_sim()
        sim.thermo_multi = a[0] == "multi"
        if a[0] == "one":
            sim.thermo_style = ["step", "temp", "epair", "emol", "etotal",
                                "press"]
        elif a[0] == "custom":
            unknown = [k for k in a[1:] if k not in THERMO_KEYS
                       and not k.startswith(("c_", "v_", "f_"))]
            if unknown:
                raise NotImplementedError(
                    f"thermo_style custom keywords {unknown} are not ported")
            sim.thermo_style = a[1:]
        elif a[0] != "multi" or len(a) > 1:
            raise NotImplementedError(
                f"thermo_style {' '.join(a)} is not ported (one, multi, "
                "custom)")

    def cmd_thermo_modify(self, a):
        """thermo_modify norm yes|no and lost error|warn|ignore
        (tpumd/script/parser.py:1134-1140)."""
        kw = dict(zip(a[::2], a[1::2]))
        if len(a) % 2 or set(kw) - {"norm", "lost"} \
                or kw.get("norm", "yes") not in ("yes", "no") \
                or kw.get("lost", "error") not in ("error", "warn",
                                                   "ignore"):
            raise NotImplementedError(
                f"thermo_modify {' '.join(a)} is not ported (only norm "
                "yes|no and lost error|warn|ignore)")
        sim = self._require_sim()
        if "norm" in kw:
            sim.thermo_norm = kw["norm"] == "yes"
        if "lost" in kw:
            sim.lost_policy = kw["lost"]

    def _group_bit(self, name):
        if name not in self.sim.groups:
            raise ScriptError(f"undefined group {name!r}")
        return self.sim.groups[name]

    def cmd_group(self, a):
        """group name type|id t... (values and lo:hi ranges) | region R |
        subtract g1 g2... | union g1... | intersect g1...
        (src/group.cpp, tpumd/script/parser.py:1689-1740): each group is
        one bit of the atoms' gmask, bit 1 being group all."""
        if self.sim is None or (self.sim.state is None
                                and not self._atoms_x):
            raise ScriptError("group before the atoms exist")
        self._finalize_atoms()
        sim = self.sim
        name, style = a[0], a[1]
        styles = ("type", "id", "region", "subtract", "union", "intersect")
        if style not in styles or len(a) < 3:
            raise NotImplementedError(
                f"group {' '.join(a[1:])} is not ported (only "
                f"{', '.join(styles)})")
        sim.invalidate_ctx()
        s = sim.state
        gm = (torch.ones_like(s.tag) if s.gmask is None
              else s.gmask.clone())
        if style in ("type", "id"):
            val = s.type if style == "type" else s.tag
            sel = torch.zeros_like(s.tag, dtype=torch.bool)
            for tok in a[2:]:
                if ":" in tok:
                    lo, hi = (int(v) for v in tok.split(":")[:2])
                    sel |= (val >= lo) & (val <= hi)
                else:
                    sel |= val == int(tok)
        elif style == "region":
            sel = torch.as_tensor(self._select("region", a[2]),
                                  device=sim.device)
        else:
            member = [(gm & self._group_bit(g)) > 0 for g in a[2:]]
            sel = member[0]
            for m in member[1:]:
                if style == "subtract":
                    sel = sel & ~m
                elif style == "union":
                    sel = sel | m
                else:
                    sel = sel & m
        bit = sim.groups.setdefault(name, 1 << len(sim.groups))
        sim.state = s.replace(gmask=torch.where(sel, gm | bit, gm))

    def cmd_compute(self, a):
        """compute ID group style args (src/modify.cpp add_compute;
        md/compute_styles.py::create_compute); a compute defined after a
        run takes its reference state at once."""
        sim = self._require_sim()
        cid, group, style = a[0], a[1], a[2]
        self._group_bit(group)
        c = create_compute(cid, group, style, a[3:])
        sim.computes[cid] = c
        if sim._carry is not None:
            c.setup(sim)

    _RIGID_STYLES = tuple(f"rigid{ens}{small}"
                          for ens in ("", "/nve", "/nvt", "/npt", "/nph")
                          for small in ("", "/small"))
    _WALL_STYLES = ("wall/lj93", "wall/lj126", "wall/harmonic",
                    "wall/reflect")
    _OUTPUT_FIXES = ("ave/time", "ave/atom", "ave/histo", "ave/correlate",
                     "ave/chunk", "print", "halt", "store/state",
                     "property/atom")
    # the fixes that act on the whole system whatever their group: a
    # subgroup raises (shake and rattle as tpumd; the others read the
    # temperature or move the box of every atom)
    _ALL_ONLY = ("shake", "rattle", "temp/berendsen", "temp/rescale",
                 "press/berendsen", "deform")
    _NEMD_FIXES = ("thermal/conductivity", "viscosity", "heat", "oneway",
                   "vector")
    # the host fixes of md/fix_misc.py by style, and their count of
    # positional values
    _MISC_FIXES = {"setforce": 3, "addforce": 3, "spring/self": 1,
                   "viscous": 1, "efield": 3, "drag": 5, "aveforce": 3,
                   "planeforce": 3, "lineforce": 3, "temp/rescale": 5,
                   "temp/berendsen": 3, "enforce2d": 0}

    def cmd_fix(self, a):
        sim = self.sim
        fid, group, style, args = a[0], a[1], a[2], a[3:]
        if group != "all" and style in self._ALL_ONLY:
            raise NotImplementedError(
                f"fix {fid} {style} on group {group!r}: the port's fix "
                f"{style} acts on every atom, so only group all is ported")
        if style == "neb":
            # the band spring and group for the neb command (src/REPLICA/
            # fix_neb.cpp:57; tpumd/script/parser.py:1145-1150): the
            # projection runs inside the band minimizer (md/neb.py)
            if len(args) != 1:
                raise NotImplementedError(
                    f"fix neb {' '.join(args)} is not ported (only Kspring)")
            self._group_bit(group)
            self._neb_fix = (group, float(args[0]))
            return
        if style == "nve/sphere" and not args:
            fx = FixNVESphere()
        elif style == "hyper/global" and len(args) == 4:
            fx = FixHyperGlobal(*(float(t) for t in args),
                                boltz=self._require_sim().units.boltz)
        elif style == "external":
            fx = FixExternal.parse(args)
        elif style == "freeze" and not args:
            fx = FixFreeze()
        elif style == "gravity" and len(args) >= 2:
            fx = FixGravity(args[0], args[1], *args[2:])
        elif style == "nve" and not args:
            fx = FixNVE()
        elif style == "nve/limit" and len(args) == 1:
            fx = FixNVELimit(float(args[0]))
        elif style == "nve/noforce" and not args:
            fx = FixNVENoforce()
        elif style in self._MISC_FIXES:
            fx = self._parse_misc_fix(style, args)
        elif style == "spring":
            if len(args) != 6 or args[0] != "tether":
                raise NotImplementedError(
                    f"fix spring {' '.join(args)} is not ported (only "
                    "tether K x y z R0)")
            fx = fm.FixSpring(float(args[1]), *self._nulls(args[2:5]),
                              float(args[5]))
        elif style == "recenter":
            if args[3:] not in ([], ["units", "box"]) and any(
                    t not in ("INIT", "NULL") for t in args[:3]):
                raise NotImplementedError(
                    f"fix recenter {' '.join(args)} is not ported (box "
                    "units, as tpumd reads them)")
            fx = fm.FixRecenter(*args[:3])
        elif style == "momentum":
            if args[1:] not in ([], ["linear", "1", "1", "1"]):
                raise NotImplementedError(
                    f"fix momentum {' '.join(args)} is not ported (only N "
                    "[linear 1 1 1])")
            fx = fm.FixMomentum(int(args[0]))
        elif style == "indent":
            fx = self._parse_indent(args)
        elif style == "press/berendsen":
            fx = self._parse_press_berendsen(args)
        elif style == "move":
            fx = self._parse_fix_move(args)
        elif style == "deform":
            fx = self._parse_deform(args)
        elif style == "langevin" and len(args) == 4:
            fx = FixLangevin(*args[:3], int(args[3]), device=sim.device)
        elif style in ("nvt", "npt", "nph"):
            fx = FixNH.parse(style, args)
        elif style == "shake":
            fx = FixShake.parse(args)
        elif style == "rattle":
            fx = FixRattle.parse(args)
        elif style in self._RIGID_STYLES:
            fx = self._parse_rigid(style, args)
        elif style == "wall/gran":
            fx = FixWallGran(*args)
        elif style in self._WALL_STYLES:
            walls = parse_walls(style, args, None if self.lattice is None
                                else self.lattice.spacing)
            fx = {"wall/lj93": FixWallLJ93, "wall/lj126": FixWallLJ126,
                  "wall/harmonic": FixWallHarmonic,
                  "wall/reflect": FixWallReflect}[style](walls)
        elif style == "pour":
            fx = FixPour(self.regions, *args)
        elif style == "deposit":
            fx = self._parse_deposit(args)
        elif style == "evaporate" and len(args) == 4:
            fx = FixEvaporate(args[0], args[1], self.regions[args[2]],
                              args[3])
        elif style in self._OUTPUT_FIXES:
            fx = self._parse_output_fix(style, args)
        elif style == "tune/kspace" and len(args) == 1:
            fx = FixTuneKspace(args[0])
        elif style == "balance" and len(args) >= 3:
            fx = FixBalance(args[0], args[1], args[2],
                            args[3] if args[2] == "shift" else "")
        elif style in self._NEMD_FIXES:
            fx = self._parse_nemd(style, args)
        elif style in ("bond/break", "bond/create"):
            fx = self._parse_bond_mc(style, args)
        elif style == "ave/grid":
            vals, kw = list(args[6:]), {}
            if "norm" in vals:
                k = vals.index("norm")
                kw["norm"] = vals[k + 1]
                vals = vals[:k] + vals[k + 2:]
            fx = FixAveGrid(*args[:6], vals, **kw)
            fx.dimension = sim.dimension
        else:
            raise NotImplementedError(
                f"fix {' '.join(a[1:])!r} is not ported (only nve, "
                "nve/limit, nve/noforce, 'langevin Tstart Tstop damp seed', "
                "nvt, npt, nph, shake, rattle, the rigid styles, "
                "nve/sphere, freeze, gravity, the walls, pour, deposit, "
                "evaporate, move, deform, press/berendsen, spring, "
                "recenter, momentum, indent and "
                f"{', '.join(self._MISC_FIXES)})")
        sim.fixes = [fx for fx in sim.fixes if fx.id != fid]
        fx.id = fid
        fx.groupbit = self._group_bit(group)
        sim.fixes.append(fx)
        sim.invalidate_ctx()
        if style in ("pour", "store/state", "property/atom"):
            # pour's nfreq takes the timestep at the fix's definition (the
            # reference computes it in the constructor); store/state stores
            # its values and property/atom makes its columns there
            self._finalize_atoms()
            fx.host_setup(sim)

    @staticmethod
    def _nulls(toks):
        """Floats, None for NULL."""
        return [None if t == "NULL" else float(t) for t in toks]

    def _parse_misc_fix(self, style, args):
        """The fixes of md/fix_misc.py with positional values only
        (tpumd/script/parser.py:1391-1462); a NULL force component is
        None, the field of efield is scaled by qe2f."""
        n = self._MISC_FIXES[style]
        if len(args) != n:
            raise NotImplementedError(
                f"fix {style} {' '.join(args)} is not ported (only its {n} "
                "values, without keywords)")
        if style in ("setforce", "aveforce"):
            cls = fm.FixSetForce if style == "setforce" else fm.FixAveForce
            return cls(*self._nulls(args))
        if style == "drag":
            return fm.FixDrag(*self._nulls(args[:3]), float(args[3]),
                              float(args[4]))
        if style == "efield":
            qe2f = self.sim.units.qe2f
            return fm.FixEfield(*[qe2f * float(v) for v in args])
        if style == "temp/rescale":
            return fm.FixTempRescale(int(args[0]), *map(float, args[1:]))
        cls = {"addforce": fm.FixAddForce, "spring/self": fm.FixSpringSelf,
               "viscous": fm.FixViscous, "planeforce": fm.FixPlaneForce,
               "lineforce": fm.FixLineForce,
               "temp/berendsen": fm.FixTempBerendsen,
               "enforce2d": fm.FixEnforce2D}[style]
        return cls(*map(float, args))

    def _parse_indent(self, args):
        """fix indent K sphere x y z R [side in|out] [units box|lattice]
        (tpumd/script/parser.py:1430-1446): the geometry in lattice
        spacings unless units box."""
        rest = dict(zip(args[6::2], args[7::2]))
        if len(args) < 6 or args[1] != "sphere" or len(args[6:]) % 2 \
                or set(rest) - {"side", "units"}:
            raise NotImplementedError(
                f"fix indent {' '.join(args)} is not ported (only K sphere "
                "x y z R [side in|out] [units box|lattice])")
        scale = (1.0, 1.0, 1.0)
        if rest.get("units", "lattice") != "box" and self.lattice is not None:
            scale = self.lattice.spacing
        ctr = [float(v) * sc for v, sc in zip(args[2:5], scale)]
        return fm.FixIndent(float(args[0]), *ctr, float(args[5]) * scale[0],
                            side=rest.get("side", "out"))

    @staticmethod
    def _parse_press_berendsen(args):
        """fix press/berendsen iso|aniso|x|y|z Pstart Pstop Pdamp ...
        [couple xyz|none] [modulus B] [dilate all]
        (tpumd/script/parser.py:1350-1389)."""
        flags, start, stop = [False] * 3, [0.0] * 3, [0.0] * 3
        period = [1.0] * 3
        modulus, couple = 10.0, False
        i = 0
        while i < len(args):
            k = args[i]
            if k in ("iso", "aniso", "x", "y", "z"):
                dims = range(3) if k in ("iso", "aniso") else ["xyz".index(k)]
                for d in dims:
                    flags[d] = True
                    start[d], stop[d], period[d] = map(
                        float, args[i + 1:i + 4])
                couple = couple or k == "iso"
                i += 4
            elif k == "couple" and args[i + 1] in ("xyz", "none"):
                couple = args[i + 1] == "xyz"
                i += 2
            elif k == "modulus":
                modulus = float(args[i + 1])
                i += 2
            elif k == "dilate" and args[i + 1] == "all":
                i += 2
            else:
                raise NotImplementedError(
                    f"fix press/berendsen keyword {' '.join(args[i:i + 2])} "
                    "is not ported (iso, aniso, x, y, z, couple xyz|none, "
                    "modulus, dilate all)")
        return fm.FixPressBerendsen(flags, start, stop, period,
                                    modulus=modulus, couple=couple)

    def _parse_fix_move(self, args):
        """fix move linear|wiggle|rotate|transrot|variable ... [units
        box|lattice] (src/fix_move.cpp:71-222; tpumd/script/parser.py:
        1753-1800): lengths in lattice spacings unless units box."""
        mstyle, rest = args[0], list(args[1:])
        scaleflag = True
        if len(rest) >= 2 and rest[-2] == "units":
            scaleflag = rest[-1] == "lattice"
            rest = rest[:-2]
        sp = (self.lattice.spacing if scaleflag and self.lattice is not None
              else (1.0, 1.0, 1.0))
        nvals = {"linear": 3, "wiggle": 4, "rotate": 7, "transrot": 10,
                 "variable": 6}
        if mstyle not in nvals or len(rest) != nvals[mstyle]:
            raise NotImplementedError(
                f"fix move {' '.join(args)} is not ported (linear, wiggle, "
                "rotate, transrot, variable, then units box|lattice)")
        step = self.sim.step

        def scaled(vals):
            return [None if v is None else v * sp[c]
                    for c, v in enumerate(vals)]
        if mstyle == "linear":
            return FixMove(FixMove.LINEAR, vel=scaled(self._nulls(rest)),
                           time_origin=step)
        if mstyle == "wiggle":
            return FixMove(FixMove.WIGGLE, amp=scaled(self._nulls(rest[:3])),
                           period=float(rest[3]), time_origin=step)
        if mstyle == "rotate":
            return FixMove(FixMove.ROTATE,
                           point=scaled([float(t) for t in rest[:3]]),
                           axis=[float(t) for t in rest[3:6]],
                           period=float(rest[6]), time_origin=step)
        if mstyle == "transrot":
            return FixMove(FixMove.TRANSROT,
                           vel=scaled([float(t) for t in rest[:3]]),
                           point=scaled([float(t) for t in rest[3:6]]),
                           axis=[float(t) for t in rest[6:9]],
                           period=float(rest[9]), time_origin=step)
        fx = FixMove(FixMove.VARIABLE, time_origin=step, varnames=[
            None if t == "NULL" else t.removeprefix("v_") for t in rest])
        fx.script = self
        return fx

    def _parse_deform(self, args):
        """fix deform N dim style values ... [remap x|none] [units box]
        (tpumd/script/parser.py:1615-1640).  final, delta and vel read
        their distances in box units, as tpumd does, so they need units
        box where a lattice is defined."""
        specs, remap, units = {}, "x", None
        i = 1
        while i < len(args):
            key = args[i]
            if key in ("x", "y", "z") and args[i + 1] in NARGS:
                n = NARGS[args[i + 1]]
                specs["xyz".index(key)] = (args[i + 1],) + tuple(
                    float(v) for v in args[i + 2:i + 2 + n])
                i += 2 + n
            elif key in ("remap", "units"):
                if key == "remap":
                    remap = args[i + 1]
                else:
                    units = args[i + 1]
                i += 2
            else:
                raise NotImplementedError(
                    f"fix deform {' '.join(args[i:i + 2])} is not ported "
                    f"(x, y, z with {', '.join(NARGS)}; remap; units box)")
        distances = any(sp[0] in ("final", "delta", "vel")
                        for sp in specs.values())
        if distances and self.lattice is not None and units != "box":
            raise NotImplementedError(
                "fix deform final/delta/vel in lattice units is not ported "
                "(tpumd reads them in box units): give units box")
        return FixDeform(int(args[0]), specs, remap)

    @staticmethod
    def _keywords(vals, keys):
        """(vals without the `key value` pairs of keys, {key: value})."""
        kw, out, i = {}, [], 0
        while i < len(vals):
            if vals[i] in keys and i + 1 < len(vals):
                kw[vals[i]] = vals[i + 1]
                i += 2
            else:
                out.append(vals[i])
                i += 1
        return out, kw

    def _parse_output_fix(self, style, args):
        """The output fixes (tpumd/script/parser.py:1483-1577): keywords
        exactly tpumd's; any other raises naming itself."""
        if style == "ave/time":
            vals, kw = self._keywords(args[3:], ("file", "mode"))
            if kw.get("mode", "scalar") not in ("scalar", "vector"):
                raise NotImplementedError(f"fix ave/time mode {kw['mode']}")
            check_inputs(style, vals)
            return FixAveTime(*args[:3], vals, file=self._opt_path(kw),
                              mode_vector=kw.get("mode") == "vector")
        if style == "ave/atom":
            return FixAveAtom(*args[:3], args[3:])
        if style == "ave/correlate":
            vals, kw = self._keywords(args[3:], ("file", "type", "ave"))
            check_inputs(style, vals)
            return FixAveCorrelate(*args[:3], vals,
                                   ctype=kw.get("type", "auto"),
                                   ave=kw.get("ave", "one"),
                                   file=self._opt_path(kw))
        if style == "ave/histo":
            vals, kw = self._keywords(args[6:], ("file", "beyond", "mode",
                                                 "ave"))
            if kw.get("ave", "one") != "one":
                raise NotImplementedError(
                    f"fix ave/histo ave {kw['ave']} is not ported (tpumd "
                    "takes ave one)")
            return FixAveHisto(*args[:6], vals, file=self._opt_path(kw),
                               beyond=kw.get("beyond", "ignore"))
        if style == "ave/chunk":
            vals, kw = self._keywords(args[4:], ("file",))
            cid = args[3][2:] if args[3].startswith("c_") else args[3]
            return FixAveChunk(*args[:3], cid, vals, file=self._opt_path(kw))
        if style == "store/state":
            if "com" in args:
                raise NotImplementedError("fix store/state keyword com is "
                                          "not ported (tpumd lacks it)")
            return FixStoreState(args[0], args[1:])
        if style == "property/atom":
            bad = [n for n in args if not n.startswith(("i_", "d_"))]
            if bad or not args:
                raise NotImplementedError(
                    f"fix property/atom {bad or args}: only i_/d_ custom "
                    "columns are ported (mol, q and rmass live in the atom "
                    "styles)")
            return FixPropertyAtom(args)
        if style == "print":
            rest, kw = self._keywords(args[2:], ("file",))
            if rest:
                raise NotImplementedError(f"fix print keywords {rest}")
            return FixPrint(args[0], args[1], file=self._opt_path(kw))
        if len(args) != 4:
            raise NotImplementedError(
                f"fix halt {' '.join(args)}: only N attribute op value is "
                "ported")
        return FixHalt(*args)

    def _opt_path(self, kw):
        return self._path(kw["file"]) if "file" in kw else None

    def _parse_deposit(self, args):
        """fix ID group deposit N type M seed region R [vx lo hi] [vy lo
        hi] [vz lo hi] [near R] [attempt Q] [units box|lattice]
        (tpumd/script/parser.py:1584-1610; tpumd reads velocities and near
        as given, and so does the port)."""
        kw, region, i = {}, None, 4
        while i < len(args):
            key = args[i]
            if key == "region":
                region = self.regions[args[i + 1]]
                i += 2
            elif key in ("vx", "vy", "vz"):
                kw[key] = (float(args[i + 1]), float(args[i + 2]))
                i += 3
            elif key == "near":
                kw["near"] = float(args[i + 1])
                i += 2
            elif key == "attempt":
                kw["maxattempt"] = int(args[i + 1])
                i += 2
            elif key == "units":
                i += 2
            else:
                raise NotImplementedError(f"fix deposit keyword {key!r} is "
                                          "not ported")
        if region is None:
            raise ScriptError("fix deposit requires a region")
        return FixDeposit(*args[:4], region, **kw)

    def _parse_rigid(self, style, args):
        """fix ID group rigid[/nve|/nvt|/npt|/nph][/small] single|molecule|
        group N g1 ... [temp T1 T2 Tdamp] [tparam chain iter order]
        [iso|aniso P1 P2 Pdamp] [x|y|z P1 P2 Pdamp] [pchain N]
        [dilate all] (tpumd/script/parser.py:1271-1350)."""
        bstyle, rest, bits = args[0] if args else None, args[1:], []
        if bstyle == "group":
            n = int(args[1])
            bits = [self._group_bit(g) for g in args[2:2 + n]]
            rest = args[2 + n:]
        elif bstyle not in ("single", "molecule"):
            raise NotImplementedError(f"fix {style} bodystyle {bstyle!r} is "
                                      "not ported (single, molecule, group)")
        kw, i = {}, 0
        while i < len(rest):
            key = rest[i]
            if key in ("temp", "tparam", "iso", "aniso", "x", "y", "z"):
                vals = rest[i + 1:i + 4]
                if len(vals) < 3:
                    raise ScriptError(f"fix {style} {key}: 3 values")
                i += 4
            elif key in ("pchain", "dilate"):
                vals = rest[i + 1:i + 2]
                i += 2
            else:
                raise NotImplementedError(
                    f"fix {style} keyword {key!r} is not ported (temp, "
                    "tparam, iso, aniso, x, y, z, pchain, dilate all)")
            if key == "temp":
                kw.update(zip(("t_start", "t_stop", "t_period"),
                              map(float, vals)))
            elif key == "tparam":
                kw.update(zip(("t_chain", "t_iter", "t_order"),
                              map(int, vals)))
            elif key in ("iso", "aniso"):
                p0, p1, pp = map(float, vals)
                kw.update(p_start=[p0] * 3, p_stop=[p1] * 3,
                          p_period=[pp] * 3, p_flag=(True,) * 3, pstyle=key)
            elif key in ("x", "y", "z"):
                d = "xyz".index(key)
                ps = kw.setdefault("p_start", [0.0] * 3)
                pe = kw.setdefault("p_stop", [0.0] * 3)
                pp = kw.setdefault("p_period", [1.0] * 3)
                pf = list(kw.get("p_flag", (False,) * 3))
                ps[d], pe[d], pp[d] = map(float, vals)
                pf[d] = True
                kw.update(p_flag=tuple(pf), pstyle="aniso")
            elif key == "pchain":
                kw["p_chain"] = int(vals[0])
            elif vals != ["all"]:
                raise NotImplementedError(
                    f"fix {style} dilate {' '.join(vals)}: the port dilates "
                    "all atoms only")
        ens = style.split("/")[1] if "/" in style else "nve"
        baro = ("p_start", "p_stop", "p_period", "p_flag", "pstyle",
                "p_chain")
        if ens in ("nve", "small"):
            if kw:
                raise ScriptError(f"fix {style} takes no thermostat or "
                                  "barostat keyword")
            return FixRigid(style=bstyle, group_bits=bits)
        if ens == "nvt":
            if any(k in kw for k in baro):
                raise ScriptError(f"fix {style} takes no pressure keyword")
            return FixRigidNVT(style=bstyle, group_bits=bits, **kw)
        if ens == "nph":
            if any(k in kw for k in ("t_start", "t_stop", "t_period")):
                raise ScriptError(f"fix {style} takes no temp keyword")
            return FixRigidNPH(style=bstyle, group_bits=bits, **kw)
        return FixRigidNPT(style=bstyle, group_bits=bits, **kw)

    @staticmethod
    def _keyword_values(args, start, keys):
        """{key: value} of the optional (key value) pairs from start on;
        another word raises."""
        rest, out = args[start:], {}
        for key, val in zip(rest[::2], rest[1::2]):
            if key not in keys:
                raise NotImplementedError(f"keyword {key!r} is not ported "
                                          f"(only {', '.join(keys)})")
            out[key] = val
        if len(rest) % 2:
            raise ScriptError(f"odd keyword list {rest}")
        return out

    def _parse_nemd(self, style, args):
        """The NEMD fixes of md/fix_nemd.py (tpumd/script/parser.py:
        1188-1215)."""
        if style == "thermal/conductivity":
            kw = self._keyword_values(args, 3, ("swap",))
            return FixThermalConductivity(args[0], args[1], args[2],
                                          nswap=int(kw.get("swap", 1)))
        if style == "viscosity":
            kw = self._keyword_values(args, 4, ("swap", "vtarget"))
            vt = kw.get("vtarget", "INF")
            return FixViscosity(args[0], args[1], args[2], args[3],
                                nswap=int(kw.get("swap", 1)),
                                vtarget=BIG if vt == "INF" else float(vt))
        if style == "heat":
            if len(args) != 2:
                raise NotImplementedError(
                    f"fix heat {' '.join(args)} is not ported (N eflux)")
            return FixHeat(args[0], args[1])
        if style == "oneway":
            if len(args) != 3:
                raise NotImplementedError(
                    f"fix oneway {' '.join(args)} is not ported (N region "
                    "direction)")
            return FixOneway(args[0], self.regions[args[1]], args[2])
        return FixVector(args[0], args[1:])

    def _parse_bond_mc(self, style, args):
        """fix bond/break N btype Rmax [prob f seed] and fix bond/create N
        itype jtype Rmin btype [iparam max itype] [jparam max jtype] [prob
        f seed] (tpumd/script/parser.py:1216-1250): prob and type changes
        raise."""
        if style == "bond/break":
            prob = 1.0
            if len(args) > 3:
                if args[3] != "prob" or len(args) != 6:
                    raise NotImplementedError(
                        f"fix bond/break {' '.join(args[3:])} is not ported")
                prob = float(args[4])
            return FixBondBreakMC(args[0], args[1], args[2], prob=prob)
        imax = jmax = 0
        i = 5
        while i < len(args):
            key = args[i]
            if key in ("iparam", "jparam"):
                want = args[1] if key == "iparam" else args[2]
                if int(args[i + 2]) != int(want):
                    raise NotImplementedError(
                        f"fix bond/create {key}: a type change is not "
                        "ported")
                if key == "iparam":
                    imax = int(args[i + 1])
                else:
                    jmax = int(args[i + 1])
                i += 3
            elif key == "prob":
                raise NotImplementedError(
                    "fix bond/create prob is not ported: the reference draws "
                    "RanMars numbers only for the atoms with a partner")
            else:
                raise NotImplementedError(
                    f"fix bond/create keyword {key!r} is not ported")
        return FixBondCreateMC(args[0], args[1], args[2], args[3], args[4],
                               imaxbond=imax, jmaxbond=jmax)

    _RESPA_TERMS = ("bond", "angle", "dihedral", "improper", "pair",
                    "kspace")

    def cmd_run_style(self, a):
        """run_style verlet | respa N n1 ... n(N-1) term level ...
        (src/respa.cpp; tpumd/script/parser.py:1864-1894): each of bond,
        angle, dihedral, improper, pair and kspace at a level, those not
        named at the outermost; the r-space split (inner, middle, outer)
        and the other keywords raise."""
        sim = self._require_sim()
        sim.invalidate_ctx()
        if a == ["verlet"]:
            sim.respa = None
            return
        if a[0] != "respa" or len(a) < 2:
            raise NotImplementedError(
                f"run_style {' '.join(a)} is not ported (verlet, respa)")
        nlev = int(a[1])
        loops = tuple(int(v) for v in a[2:1 + nlev]) + (1,)
        cats = [set() for _ in range(nlev)]
        kw = a[1 + nlev:]
        for key, lvl in zip(kw[::2], kw[1::2]):
            if key not in self._RESPA_TERMS:
                raise NotImplementedError(
                    f"run_style respa keyword {key!r} is not ported (only "
                    f"{', '.join(self._RESPA_TERMS)} at a level)")
            cats[int(lvl) - 1].add(key)
        if len(kw) % 2 or len(loops) != nlev:
            raise ScriptError(f"run_style {' '.join(a)}: bad arguments")
        named = set().union(*cats)
        cats[-1] |= set(self._RESPA_TERMS) - named
        sim.respa = (loops, tuple(tuple(sorted(c)) for c in cats))

    # ------------------------------------------------- replica commands
    def _fix_by_id(self, fid):
        for fx in self.sim.fixes:
            if fx.id == fid:
                return fx
        return None

    def cmd_temper(self, a):
        """temper N M temp fix-ID seed1 seed2 (src/REPLICA/temper.cpp;
        tpumd/script/parser.py:1896-1921): one replica per value of the
        first world variable, each a script that replays the lines run so
        far as its own world; parallel tempering with configuration swaps
        (md/temper.py).  The replicas are kept in ``replicas`` (this
        script's simulation first), the swaps of each window in
        ``temper_accepts``."""
        from tpumd_torch.md.temper import temper as run_temper
        if len(a) not in (6, 7):
            raise ScriptError("temper N M temp fix-ID seed1 seed2 [index]")
        nsteps, nevery = int(a[0]), int(a[1])
        worlds = [v for st, v in self.variables.values() if st == "world"]
        if not worlds:
            raise ScriptError("temper requires a world-style variable "
                              "defining the replica temperatures")
        self._finalize_atoms()
        if self._fix_by_id(a[3]) is None:
            raise ScriptError(f"tempering fix ID {a[3]!r} is not defined")
        temps = [float(v) for v in worlds[0]]
        sims = [self.sim]
        for i in range(1, len(temps)):
            sc = LammpsScript(device=self.device, dtype=self.dtype,
                              var_overrides=self._var_overrides)
            sc.data_dir = self.data_dir
            sc._world_index = i
            sc.nworlds = len(temps)
            for line in self._history[:-1]:
                sc.execute(line)
            sc._finalize_atoms()
            sims.append(sc.sim)
        for sim in sims:
            sim.verbose = False
        self.temper_stats = {}
        self.temper_accepts = run_temper(
            sims, temps, nsteps, nevery, int(a[4]), int(a[5]),
            self.sim.units.boltz, log=self.sim._log, stats=self.temper_stats)
        self.replicas = sims

    def _event_compute(self, cid, cmd):
        """The compute event/displace that a replica command names."""
        comp = self.sim.computes.get(cid)
        if comp is None or comp.style != "event/displace":
            raise ScriptError(f"{cmd} compute-ID must name a compute "
                              "event/displace")
        return comp

    @staticmethod
    def _min_keyword(a, i, kw):
        kw["etol"], kw["ftol"] = float(a[i + 1]), float(a[i + 2])
        kw["maxiter"], kw["maxeval"] = int(a[i + 3]), int(a[i + 4])
        return i + 5

    def cmd_neb(self, a):
        """neb etol ftol N1 N2 Nevery final file replicas R
        (src/REPLICA/neb.cpp; tpumd/script/parser.py:2086-2123): the band of
        R images between the current state and the file's coordinates,
        relaxed by climbing-image NEB (md/neb.py); ``replicas R`` stands in
        for the reference's -partition.  Needs a prior ``fix ID group neb
        K``.  The result is kept in ``neb_result``."""
        from tpumd_torch.md.neb import neb, read_neb_file
        if not hasattr(self, "_neb_fix"):
            raise ScriptError("neb requires a fix neb command")
        if len(a) < 7 or a[5] != "final":
            raise ScriptError("neb etol ftol N1 N2 Nevery final file "
                              "replicas R (only the final file style)")
        etol, ftol = float(a[0]), float(a[1])
        n1, n2, nevery = int(a[2]), int(a[3]), int(a[4])
        kw = dict(zip(a[7::2], a[8::2]))
        if "replicas" not in kw:
            raise ScriptError("neb needs 'replicas R' (the reference "
                              "takes the count from -partition)")
        self._finalize_atoms()
        group, kspring = self._neb_fix
        tags, xyz = read_neb_file(self._path(a[6]), self.sim.natoms)
        self.neb_result = neb(self.sim, etol, ftol, n1, n2, nevery, tags, xyz,
                              kspring=kspring, nreplica=int(kw["replicas"]),
                              group_bit=self._group_bit(group),
                              log=self.sim._log)

    def cmd_prd(self, a):
        """prd N t_event n_dephase t_dephase t_correlate compute-ID seed
        [min etol ftol maxiter maxeval] [temp T] [vel loop dist] [time
        steps|clock] replicas R (src/REPLICA/prd.cpp;
        tpumd/script/parser.py:1923-1972): ``replicas R`` stands in for
        -partition.  The event rows are kept in ``prd_events``."""
        from tpumd_torch.md.prd import PRD, EventDetector
        nsteps, t_event = int(a[0]), int(a[1])
        n_dephase, t_dephase, t_corr = int(a[2]), int(a[3]), int(a[4])
        cid, seed = a[5], int(a[6])
        kw = dict(etol=0.1, ftol=0.1, maxiter=40, maxeval=50)
        nreplica, i = None, 7
        while i < len(a):
            if a[i] == "min":
                i = self._min_keyword(a, i, kw)
            elif a[i] == "temp":
                kw["temp"], i = float(a[i + 1]), i + 2
            elif a[i] == "vel":
                # loop geom draws whatever loop style is named, as tpumd
                kw["dist"], i = a[i + 2], i + 3
            elif a[i] == "time":
                kw["stepmode"], i = int(a[i + 1] != "steps"), i + 2
            elif a[i] == "replicas":
                nreplica, i = int(a[i + 1]), i + 2
            else:
                raise ScriptError(f"unknown prd keyword {a[i]!r}")
        if nreplica is None:
            raise ScriptError("prd needs 'replicas R' (the reference "
                              "takes replicas from -partition)")
        self._finalize_atoms()
        sim = self.sim
        comp = self._event_compute(cid, "prd")
        det = comp.detector = EventDetector(comp.displace_dist)
        runner = PRD(sim, nreplica, det, seed, log=sim._log, **kw)
        sim._log("Step CPU Clock Event Correlated Coincident Replica")
        self.prd_runner = runner
        self.prd_events = runner.run(nsteps, t_event, n_dephase, t_dephase,
                                     t_corr)

    def cmd_tad(self, a):
        """tad N t_event T_lo T_hi delta_conf tmax compute-ID [min etol ftol
        maxiter maxeval] [neb etol ftol N1 N2 Nevery] [neb_style, neb_step,
        neb_log: accepted, ignored] replicas R (src/REPLICA/tad.cpp;
        tpumd/script/parser.py:1974-2021): ``replicas R`` is the NEB band's
        width.  The event rows are kept in ``tad_events``."""
        from tpumd_torch.md.prd import EventDetector
        from tpumd_torch.md.tad import TAD
        nsteps, t_event = int(a[0]), int(a[1])
        templo, temphi = float(a[2]), float(a[3])
        delta_conf, tmax, cid = float(a[4]), float(a[5]), a[6]
        kw = dict(etol=0.1, ftol=0.1, maxiter=40, maxeval=50,
                  etol_neb=0.01, ftol_neb=0.01, n1_neb=100, n2_neb=100,
                  nevery_neb=10, neb_replicas=4)
        i = 7
        while i < len(a):
            if a[i] == "min":
                i = self._min_keyword(a, i, kw)
            elif a[i] == "neb":
                kw["etol_neb"], kw["ftol_neb"] = float(a[i + 1]), \
                    float(a[i + 2])
                kw["n1_neb"], kw["n2_neb"] = int(a[i + 3]), int(a[i + 4])
                kw["nevery_neb"], i = int(a[i + 5]), i + 6
            elif a[i] in ("neb_style", "neb_step", "neb_log"):
                i += 2
            elif a[i] == "replicas":
                kw["neb_replicas"], i = int(a[i + 1]), i + 2
            else:
                raise ScriptError(f"unknown tad keyword {a[i]!r}")
        self._finalize_atoms()
        sim = self.sim
        comp = self._event_compute(cid, "tad")
        det = comp.detector = EventDetector(comp.displace_dist)
        runner = TAD(sim, det, templo, temphi, delta_conf, tmax,
                     log=sim._log, **kw)
        sim._log("Step CPU N M Status Barrier Margin t_lo delt_lo")
        self.tad_runner = runner
        self.tad_events = runner.run(nsteps, t_event)

    def cmd_hyper(self, a):
        """hyper N t_event fix-ID compute-ID [min etol ftol maxiter maxeval]
        [rebond N] (src/REPLICA/hyper.cpp; tpumd/script/parser.py:
        2023-2067): fix-ID NULL runs without a bias.  The statistics are
        kept in ``hyper_stats``."""
        from tpumd_torch.md.fix_hyper import hyper as run_hyper
        nsteps, t_event = int(a[0]), int(a[1])
        fid, cid = a[2], a[3]
        kw = dict(etol=1e-4, ftol=1e-4, maxiter=40, maxeval=50, rebond=0)
        i = 4
        while i < len(a):
            if a[i] == "min":
                i = self._min_keyword(a, i, kw)
            elif a[i] == "rebond":
                kw["rebond"], i = int(a[i + 1]), i + 2
            else:
                raise ScriptError(f"unknown hyper keyword {a[i]!r}")
        self._finalize_atoms()
        sim = self.sim
        comp = self._event_compute(cid, "hyper")
        fix_hyper = None
        if fid != "NULL":
            fix_hyper = self._fix_by_id(fid)
            if getattr(fix_hyper, "name", None) != "hyper/global":
                raise ScriptError("hyper fix-ID must name a fix "
                                  "hyper/global")
        self.hyper_stats = run_hyper(sim, nsteps, t_event, comp,
                                     fix_hyper=fix_hyper, log=sim._log, **kw)
        st = self.hyper_stats
        sim._log(f"hyper time = {st['t_hyper']:.6g} boost = "
                 f"{st['boost']:.6g} events = {st['nevent']}")

    # ---------------------------------------------------------- library
    def inject_atoms(self, ids, types, x, v=None):
        """lammps_create_atoms (src/library.cpp): atoms that a calling
        program hands over as arrays, after create_box and before the atoms
        are made (tpumd/script/parser.py:882-901); ids None numbers them
        on."""
        if self.box is None:
            raise ScriptError(
                "lammps_create_atoms before create_box/read_data")
        if self.sim is not None and self.sim.state is not None:
            raise ScriptError(
                "lammps_create_atoms after the atoms are made is not ported")
        n = len(x)
        self._injected[len(self._atoms_x)] = (
            None if ids is None else np.asarray(ids, np.int64).reshape(n),
            None if v is None else np.asarray(v, np.float64).reshape(n, 3))
        self._atoms_x.append(np.asarray(x, np.float64).reshape(n, 3))
        self._atoms_type.append(np.asarray(types, np.int32).reshape(n))
        for seg in (self._atoms_q, self._atoms_mol, self._atoms_image):
            seg.append(None)

    def _injected_arrays(self, natoms):
        """(tags or None, v or None) of the atoms being made, where a
        calling program handed over ids or velocities: segments without ids
        get the next tags in turn (tpumd/script/parser.py:836-845)."""
        if not self._injected:
            return None, None
        tags, v, nxt = [], np.zeros((natoms, 3)), 1
        row = 0
        for k, xa in enumerate(self._atoms_x):
            ids, va = self._injected.get(k, (None, None))
            if ids is None:
                ids = np.arange(nxt, nxt + len(xa), dtype=np.int64)
            tags.append(ids)
            nxt = max(nxt, int(ids.max(initial=0)) + 1)
            if va is not None:
                v[row:row + len(xa)] = va
            row += len(xa)
        return np.concatenate(tags).astype(np.int32), v

    def cmd_run(self, a):
        """run N [upto] (src/run.cpp; upto runs to step N)."""
        if len(a) not in (1, 2) or a[1:] not in ([], ["upto"]):
            raise NotImplementedError(f"run keywords {a[1:]} are not ported")
        self._finalize_atoms()
        n = int(a[0])
        if a[1:] == ["upto"]:
            n = max(0, n - self.sim.step)
        self.sim.run(n)

    def cmd_minimize(self, a):
        """minimize etol ftol maxiter maxeval (src/minimize.cpp;
        tpumd/script/parser.py:2131-2133)."""
        if len(a) != 4:
            raise ScriptError("minimize takes etol ftol maxiter maxeval")
        self._finalize_atoms()
        self.sim.minimize(float(a[0]), float(a[1]), int(a[2]), int(a[3]))

    def cmd_min_style(self, a):
        """min_style fire|cg|sd|quickmin|hftn (md/minimize.py)."""
        from tpumd_torch.md.minimize import STYLES
        if len(a) != 1 or a[0] not in STYLES:
            raise NotImplementedError(f"min_style {' '.join(a)} is not ported "
                                      f"({', '.join(STYLES)})")
        self._require_sim().min_style = a[0]

    # min_modify keywords at the one value each that the port's minimizer
    # computes with (tpumd ignores min_modify): dmax, tpumd's halving line
    # search, FIRE's constants, Euler-implicit steps without the half step
    # back, the 2-norm
    _MIN_MODIFY = {"dmax": 0.1, "line": "backtrack", "delaystep": 5,
                   "dtgrow": 1.1, "dtshrink": 0.5, "alpha0": 0.25,
                   "alphashrink": 0.99, "tmax": 10.0,
                   "integrator": "eulerimplicit", "halfstepback": "no",
                   "norm": "two"}

    def cmd_min_modify(self, a):
        """min_modify keyword value ...: each keyword only at the value of
        ``_MIN_MODIFY``; any other value or keyword raises, naming it."""
        if len(a) % 2:
            raise ScriptError(f"min_modify {' '.join(a)}: keyword value "
                              "pairs")
        for key, val in zip(a[::2], a[1::2]):
            want = self._MIN_MODIFY.get(key)
            if want is None:
                known = ", ".join(f"{k} {v}"
                                  for k, v in self._MIN_MODIFY.items())
                raise NotImplementedError(
                    f"min_modify {key} is not ported (only {known})")
            if str(want) != val and (isinstance(want, str)
                                     or _number(val) != want):
                raise NotImplementedError(
                    f"min_modify {key} {val} is not ported: the minimizer "
                    f"computes with {key} {want}")

    # ------------------------------------------------------------- output
    def cmd_dump(self, a):
        """dump ID group style N file [args] (src/dump.cpp): atom, custom,
        local, cfg, grid, image and movie (io/dump.py::make_dump)."""
        sim = self._require_sim()
        groupbit = 1 if a[1] == "all" else self._group_bit(a[1])
        sim.dumps = [d for d in sim.dumps if d.id != a[0]]
        sim.dumps.append(make_dump(a[0], a[1], a[2], int(a[3]),
                                   self._path(a[4]), a[5:],
                                   groupbit=groupbit))

    def _dump(self, did):
        for d in self._require_sim().dumps:
            if d.id == did:
                return d
        raise ScriptError(f"could not find dump ID {did!r}")

    def cmd_dump_modify(self, a):
        self._dump(a[0]).modify(a[1:])

    def cmd_undump(self, a):
        sim = self.sim
        sim.dumps = [d for d in sim.dumps if d is not self._dump(a[0])]

    def cmd_write_restart(self, a):
        sim = self._require_sim()
        if sim._ctx is None:
            self._finalize_atoms()
            sim.setup()
        if self._writer:
            write_restart(sim, self._path(a[0]))

    def cmd_read_restart(self, a):
        sim = self._require_sim()
        read_restart(sim, self._path(a[0]))
        self._materialize_styles()

    def cmd_write_data(self, a):
        self._finalize_atoms()
        if self._writer:
            write_data(self.sim, self._path(a[0]))

    # -------------------------------------------------------- state edits
    def _host_edit(self):
        """The simulation with its state back in natoms rows, ready to be
        edited on the host: after a set-up the atoms sit in the grid's
        slots and the forces are the last run's, so the next run sets up
        anew (re-binned, the pair list rebuilt), the fixes keeping their
        state, as tpumd does."""
        self._finalize_atoms()
        self.sim.invalidate_ctx()
        return self.sim

    def _select(self, style, ident):
        """(N,) bool of the atoms a set command names: group, type, region
        or atom (an ID, lo:hi or *)."""
        s = self.sim.state
        if style == "group":
            bit = self._group_bit(ident)
            if bit == 1:
                return np.ones(s.tag.shape[0], bool)
            return (s.gmask.cpu().numpy() & bit) > 0
        if style == "type":
            return s.type.cpu().numpy() == int(ident)
        if style == "region":
            return self.regions[ident].inside(
                s.x.cpu().numpy().astype(np.float64))
        if style == "atom":
            tag = s.tag.cpu().numpy()
            if ident == "*":
                return tag > 0
            if ":" in ident:
                lo, hi = ident.split(":")[:2]
                return (tag >= int(lo)) & (tag <= int(hi))
            return tag == int(ident)
        raise NotImplementedError(f"set style {style!r} is not ported")

    def cmd_set(self, a):
        """set group|type|region|atom ID charge|type|d_name|i_name value ...
        (src/set.cpp; tpumd/script/parser.py:752-808)."""
        sim = self._host_edit()
        sel = torch.as_tensor(self._select(a[0], a[1]), device=sim.device)
        s = sim.state
        for key, val in zip(a[2::2], a[3::2]):
            if key == "charge":
                q = (torch.zeros(s.tag.shape[0], dtype=self.dtype,
                                 device=sim.device) if s.q is None else s.q)
                s = s.replace(q=torch.where(sel, float(val), q))
            elif key.startswith(("d_", "i_")):
                store = sim.custom_peratom
                if key not in store:
                    raise ScriptError(f"set {key}: no fix property/atom "
                                      "defines it")
                tags = s.tag[sel].long().cpu().numpy() - 1
                store[key][tags] = (int(val) if key.startswith("i_")
                                    else float(val))
            elif key == "type":
                if not 1 <= int(val) <= sim.ntypes:
                    raise ScriptError(f"set type {val}: not an atom type "
                                      f"(1 to {sim.ntypes})")
                s = s.replace(type=torch.where(sel, int(val), s.type).to(
                    torch.int32))
            else:
                raise NotImplementedError(
                    f"set keyword {key!r} is not ported (only charge, type "
                    "and property/atom's d_ and i_ columns)")
        if len(a) % 2:
            raise ScriptError(f"set: odd keyword list {a[2:]}")
        sim.state = s

    def cmd_unfix(self, a):
        """unfix ID (src/modify.cpp delete_fix): the fix and its state go;
        the next run sets up anew."""
        sim = self.sim
        keep = [fx for fx in sim.fixes if fx.id != a[0]]
        if len(keep) == len(sim.fixes):
            raise ScriptError(f"could not find fix ID {a[0]!r} to delete")
        sim.fixes = keep
        sim.invalidate_ctx()

    def cmd_reset_timestep(self, a):
        self._require_sim().step = int(a[0])

    def cmd_displace_atoms(self, a):
        """displace_atoms group move dx dy dz | random dx dy dz seed
        [units box|lattice] (src/displace_atoms.cpp;
        tpumd/script/parser.py:2592-2621): the random style draws with
        RanPark reset on each atom's coordinates, as the reference does,
        so positions are bit-equal to it."""
        sim = self._host_edit()
        sel = self._select("group", a[0])
        units = a[a.index("units") + 1] if "units" in a else "lattice"
        scale = (np.asarray(self.lattice.spacing, np.float64)
                 if self.lattice is not None and units == "lattice"
                 else np.ones(3))
        x = sim.state.x.cpu().numpy().astype(np.float64)
        d = np.array([float(v) for v in a[2:5]]) * scale
        if a[1] == "move":
            x[sel] += d
        elif a[1] == "random":
            u = geom_uniform_triplets(int(a[5]), x)
            x[sel] += d[None, :] * 2.0 * (u[sel] - 0.5)
        else:
            raise NotImplementedError(
                f"displace_atoms style {a[1]!r} is not ported (only move "
                "and random)")
        sim.state = sim.state.replace(x=torch.as_tensor(
            x, dtype=self.dtype, device=sim.device))

    def cmd_delete_atoms(self, a):
        """delete_atoms region ID (src/delete_atoms.cpp), before the atoms
        are made: tags are numbered anew, as the reference's default
        compress yes does for atomic systems."""
        if a[0] != "region" or len(a) != 2:
            raise NotImplementedError(
                f"delete_atoms {' '.join(a)} is not ported (only region ID)")
        if self.sim is None or self.sim.state is not None:
            raise NotImplementedError(
                "delete_atoms after the atoms are made (read_data, a "
                "velocity or group command, a run) is not ported")
        if any(m is not None for m in self._atoms_mol):
            raise NotImplementedError(
                "delete_atoms after create_atoms ... mol is not ported (the "
                "templates' topology would lose members)")
        reg = self.regions[a[1]]
        ndel = 0
        for i, xa in enumerate(self._atoms_x):
            keep = ~reg.inside(xa)
            ndel += int((~keep).sum())
            self._atoms_x[i] = xa[keep]
            self._atoms_type[i] = self._atoms_type[i][keep]
        print(f"Deleted {ndel} atoms")

    def cmd_atom_modify(self, a):
        pass   # map and sort settings: the port keeps its own

    def cmd_dimension(self, a):
        """dimension 2|3: the dof, the pressure and velocity create count
        the dimension, as tpumd's do; a 2-D deck keeps its atoms in the
        plane with fix enforce2d."""
        if len(a) != 1 or a[0] not in ("2", "3"):
            raise ScriptError(f"dimension {' '.join(a)}: 2 or 3")
        self._require_sim().dimension = int(a[0])
