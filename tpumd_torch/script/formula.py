"""Recursive-descent formula evaluator for equal- and atom-style variables.

The port's copy of tpumd/script/formula.py (the expression core of the
reference's Variable::evaluate, src/variable.cpp:5305, src/variable.h:
62-76): arithmetic with LAMMPS operator precedence, comparison/boolean/
unary operators, math functions, thermo keywords, references to computes
(c_ID, c_ID[i]), fixes (f_ID) and other variables (v_name), and per-atom
vectors for atom-style variables (x, y, z, vx..., id, type, mass, q) —
scalar expressions broadcast.

Evaluation is host-side numpy.  ``SimFormulaContext`` reads the port's
``Simulation``: thermo keywords from the last thermo row it computed
(``Simulation.last_thermo``, so a substitution starts no device work of
its own), per-atom names from the state in tag order.
"""


from __future__ import annotations

import math
import re

import numpy as np

from tpumd_torch.md.computes import THERMO_COMPUTES

_TOKEN_RE = re.compile(r"""
    (?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>==|!=|<=|>=|&&|\|\||[-+*/%^<>!(),\[\]])
""", re.VERBOSE)


def tokenize(text: str):
    toks = []
    pos = 0
    while pos < len(text):
        if text[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ValueError(f"bad character in formula at {text[pos:]!r}")
        kind = m.lastgroup
        toks.append((kind, m.group()))
        pos = m.end()
    toks.append(("end", ""))
    return toks


_FUNCS1 = {
    "sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "log": np.log10,
    "abs": np.abs, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "floor": np.floor, "ceil": np.ceil, "round": np.round,
}
_FUNCS2 = {"pow": np.power, "atan2": np.arctan2, "min": np.minimum,
           "max": np.maximum, "logfreq": None, "random": None}


class Formula:
    """Parsed formula; evaluate(ctx) -> float or (N,) ndarray.

    ctx must provide: thermo_keyword(name) -> float | None,
    peratom(name) -> ndarray | None, variable(name) -> value,
    compute(id, index|None) -> value, fix(id, index|None) -> value,
    natoms -> int.
    """

    def __init__(self, text: str):
        self.text = text
        self._toks = tokenize(text)
        self._pos = 0
        self.root = self._parse_or()
        if self._peek()[0] != "end":
            raise ValueError(f"trailing tokens in formula {text!r}")

    # ------------------------------------------------------------- parsing
    def _peek(self):
        return self._toks[self._pos]

    def _next(self):
        t = self._toks[self._pos]
        self._pos += 1
        return t

    def _expect(self, val):
        t = self._next()
        if t[1] != val:
            raise ValueError(f"expected {val!r}, got {t[1]!r} in "
                             f"{self.text!r}")

    def _parse_or(self):
        node = self._parse_and()
        while self._peek()[1] == "||":
            self._next()
            node = ("or", node, self._parse_and())
        return node

    def _parse_and(self):
        node = self._parse_cmp()
        while self._peek()[1] == "&&":
            self._next()
            node = ("and", node, self._parse_cmp())
        return node

    def _parse_cmp(self):
        node = self._parse_addsub()
        while self._peek()[1] in ("==", "!=", "<", "<=", ">", ">="):
            op = self._next()[1]
            node = (op, node, self._parse_addsub())
        return node

    def _parse_addsub(self):
        node = self._parse_muldiv()
        while self._peek()[1] in ("+", "-"):
            op = self._next()[1]
            node = (op, node, self._parse_muldiv())
        return node

    def _parse_muldiv(self):
        node = self._parse_unary()
        while self._peek()[1] in ("*", "/", "%"):
            op = self._next()[1]
            node = (op, node, self._parse_unary())
        return node

    def _parse_unary(self):
        t = self._peek()
        if t[1] == "-":
            self._next()
            return ("neg", self._parse_unary())
        if t[1] == "!":
            self._next()
            return ("not", self._parse_unary())
        return self._parse_pow()

    def _parse_pow(self):
        node = self._parse_atom()
        if self._peek()[1] == "^":
            self._next()
            # right-associative
            return ("^", node, self._parse_unary())
        return node

    def _parse_atom(self):
        kind, val = self._next()
        if val == "(":
            node = self._parse_or()
            self._expect(")")
            return node
        if kind == "num":
            return ("num", float(val))
        if kind == "name":
            if self._peek()[1] == "(":
                self._next()
                args = []
                if self._peek()[1] != ")":
                    args.append(self._parse_or())
                    while self._peek()[1] == ",":
                        self._next()
                        args.append(self._parse_or())
                self._expect(")")
                return ("call", val, args)
            if val.startswith(("c_", "f_", "v_")) and self._peek()[1] == "[":
                self._next()
                idx = self._parse_or()
                self._expect("]")
                return ("ref", val, idx)
            return ("name", val)
        raise ValueError(f"unexpected token {val!r} in {self.text!r}")

    # ----------------------------------------------------------- evaluation
    def evaluate(self, ctx):
        return self._eval(self.root, ctx)

    def _eval(self, node, ctx):
        op = node[0]
        if op == "num":
            return node[1]
        if op == "name":
            return self._name(node[1], ctx)
        if op == "ref":
            idx = self._eval(node[2], ctx)
            return self._name(node[1], ctx, int(idx))
        if op == "neg":
            return -self._eval(node[1], ctx)
        if op == "not":
            return np.where(self._eval(node[1], ctx) == 0, 1.0, 0.0)
        if op == "call":
            return self._call(node[1], [self._eval(a, ctx)
                                        for a in node[2]], ctx)
        a = self._eval(node[1], ctx)
        b = self._eval(node[2], ctx)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return np.mod(a, b)
        if op == "^":
            return np.power(a, b)
        if op == "==":
            return np.where(a == b, 1.0, 0.0)
        if op == "!=":
            return np.where(a != b, 1.0, 0.0)
        if op == "<":
            return np.where(a < b, 1.0, 0.0)
        if op == "<=":
            return np.where(a <= b, 1.0, 0.0)
        if op == ">":
            return np.where(a > b, 1.0, 0.0)
        if op == ">=":
            return np.where(a >= b, 1.0, 0.0)
        if op == "and":
            return np.where((a != 0) & (b != 0), 1.0, 0.0)
        if op == "or":
            return np.where((a != 0) | (b != 0), 1.0, 0.0)
        raise ValueError(f"unknown op {op}")

    def _name(self, name, ctx, index=None):
        if name == "PI":
            return math.pi
        if name in ("on", "true", "yes"):
            return 1.0
        if name in ("off", "false", "no"):
            return 0.0
        if name.startswith("v_"):
            return ctx.variable(name[2:])
        if name.startswith("c_"):
            return ctx.compute(name[2:], index)
        if name.startswith("f_"):
            return ctx.fix(name[2:], index)
        pa = ctx.peratom(name)
        if pa is not None:
            return pa
        tv = ctx.thermo_keyword(name)
        if tv is not None:
            return tv
        raise ValueError(f"unknown name {name!r} in formula")

    def _call(self, fn, args, ctx):
        if fn in _FUNCS1 and len(args) == 1:
            return _FUNCS1[fn](args[0])
        if fn in ("pow", "atan2", "min", "max") and len(args) == 2:
            return _FUNCS2[fn](args[0], args[1])
        if fn == "ramp" and len(args) == 2:
            # ramp(lo, hi): lo + delta*(hi-lo) over the current run
            delta = ctx.run_delta()
            return args[0] + delta * (args[1] - args[0])
        raise ValueError(f"unknown function {fn}({len(args)} args)")



class SimFormulaContext:
    """Formula name resolution backed by the port's Simulation."""

    def __init__(self, sim, script=None):
        self.sim = sim
        self.script = script

    def thermo_keyword(self, name):
        """The simulation clock and sizes, else the last thermo row (the
        reference's Thermo::evaluate_keyword reads the values of the last
        thermo output too); None before the first set-up or after a
        command that needs a new one, as in tpumd."""
        sim = self.sim
        if sim is not None:
            if name == "dt":
                return float(sim.dt)
            if name == "time":
                return float(sim.step * sim.dt)
            if name == "step":
                return float(sim.step)
            if name in ("atoms", "natoms"):
                return float(sim.natoms)
        if sim is None or sim._carry is None:
            return None
        vals = sim.last_thermo
        if vals is None:
            vals = sim.thermo_values()
        if name in vals:
            return float(vals[name])
        return None

    _PERATOM = {"x": ("x", 0), "y": ("x", 1), "z": ("x", 2),
                "vx": ("v", 0), "vy": ("v", 1), "vz": ("v", 2),
                "fx": ("f", 0), "fy": ("f", 1), "fz": ("f", 2)}

    def peratom(self, name):
        """A per-atom vector in tag order, read from the state (slot order
        on the cell grid, padding slots carrying tag 0)."""
        s = self.sim.state
        tag = s.tag.cpu().numpy()
        valid = tag > 0
        order = np.nonzero(valid)[0][np.argsort(tag[valid])]
        if name in self._PERATOM:
            field, col = self._PERATOM[name]
            return getattr(s, field).detach().cpu().numpy().astype(
                np.float64)[order, col]
        if name == "id":
            return tag[order].astype(np.float64)
        if name == "type":
            return s.type.cpu().numpy()[order].astype(np.float64)
        if name == "mass":
            if s.rmass is not None:
                return s.rmass.cpu().numpy().astype(np.float64)[order]
            return np.asarray(self.sim.mass, np.float64)[
                s.type.cpu().numpy()[order]]
        if name == "q" and s.q is not None:
            return s.q.cpu().numpy().astype(np.float64)[order]
        if name.startswith(("i_", "d_")) and \
                name in self.sim.custom_peratom:
            # fix property/atom's columns, by tag - 1
            return np.asarray(self.sim.custom_peratom[name],
                              np.float64)[tag[order] - 1]
        return None

    def variable(self, name):
        if self.script is not None:
            return self.script.evaluate_variable(name)
        raise ValueError(f"variable {name} unavailable")

    def compute(self, cid, index):
        """c_ID: the reference's thermo computes (thermo_temp, thermo_pe,
        thermo_press) read the last thermo row; a compute of the deck is
        evaluated on the current state."""
        sim = self.sim
        if cid in THERMO_COMPUTES and index is None:
            v = self.thermo_keyword(THERMO_COMPUTES[cid])
            if v is None:
                raise ValueError(f"c_{cid} before the first run")
            # thermo_pe is extensive: thermo's pe is normalized by the
            # atom count under thermo_modify norm yes, the compute is not
            return v * sim.natoms if cid == "thermo_pe" and sim.thermo_norm \
                else v
        if cid not in sim.computes:
            raise ValueError(f"compute {cid} is not defined")
        c = sim.computes[cid]
        if c.peratom:
            # a per-atom column, in tag order (atom-style formulas)
            out = c(sim).detach().cpu().numpy().astype(np.float64)
            return out if index is None else out[:, index - 1]
        key = f"c_{cid}" if index is None else f"c_{cid}[{index}]"
        return float(sim.compute_entry(key))

    def fix(self, fid, index):
        for fx in self.sim.fixes:
            if getattr(fx, "id", None) == fid and hasattr(fx, "output"):
                out = np.asarray(fx.output(self.sim), np.float64)
                if getattr(fx, "peratom", False):
                    # ave/atom, store/state: columns in tag order
                    return out if index is None else out[:, index - 1]
                return float(out) if index is None else float(
                    out[index - 1])
        raise ValueError(f"fix {fid} has no output")

    def run_delta(self):
        return 0.0

