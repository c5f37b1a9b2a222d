"""The bonded goldens: LAMMPS decks whose reference-binary output the
port's bonded-style library is held to, and how each runs.

Fourteen decks of tests/golden run verbatim, each in a directory of its
own (they write their dumps beside themselves): bonded_extra's in.bondx,
in.anglex and in.dihx, bonded_misc's in.test, bonded_misc2's in.bnd,
in.bnd2 and in.bnd3, bonded_table's in.test, bond_quartic's in.test,
class2's in.test, bonded2's in.hyb, in.multih and in.opls (the last two
read dihedral/data.di) and dihedral's in.di.  Every one runs on the matrix
engine.  ``failures`` holds a run to the reference binary at the
tolerances of tpumd's tests of the same deck (tests/test_bonded_extra.py,
test_breadth_golden.py, test_bonded2_golden.py, test_bonded_table.py,
test_bond_quartic.py, test_class2.py, test_dihedral_golden.py): the last
thermo row at full precision, every earlier printed row of the log at the
same tolerance or within one unit of the reference's last printed digit,
whichever is wider, and the dumped per-atom forces at atol 1e-9 (quartic
1e-8) times max(1, max |f|).  Four decks have no log in the repo; their
last row is held to the reference binary's numbers that tpumd's tests
carry (``LAST_ROWS``).  bond_quartic breaks two bonds (``QUARTIC_BROKEN``).

``water_shake`` (tests/golden/water_shake: CHARMM water with SHAKE and
PPPM) runs forced onto the matrix engine and is held to its log and dump
at tests/test_golden_water.py's tolerances.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys

import numpy as np

from tpumd_torch.pair_goldens import last_digit, printed_rows

# name: (golden directory, deck, data directory or None, log or None,
# dump or None, {thermo key: (rel, abs)} with "*" the default)
_EXTRA = {"*": (1e-7, 1e-9)}
DECKS = {
    "bondx": ("bonded_extra", "in.bondx", None, "log.bondx", "dump.bondx",
              _EXTRA),
    "anglex": ("bonded_extra", "in.anglex", None, "log.anglex",
               "dump.anglex", _EXTRA),
    "dihx": ("bonded_extra", "in.dihx", None, "log.dihx", "dump.dihx",
             _EXTRA),
    "bonded_misc": ("bonded_misc", "in.test", None, "log.test", None,
                    {"*": (5e-7, 0.0), "temp": (5e-7, 1e-10),
                     "emol": (5e-7, 1e-7), "press": (5e-6, 1e-6)}),
    "bnd": ("bonded_misc2", "in.bnd", None, "log.bnd", None,
            {"*": (1e-6, 0.0), "press": (1e-5, 0.0)}),
    "bnd2": ("bonded_misc2", "in.bnd2", None, "log.bnd2", None,
             {"*": (1e-6, 0.0), "press": (1e-5, 0.0)}),
    "bnd3": ("bonded_misc2", "in.bnd3", None, "log.bnd3", None,
             {"*": (1e-6, 0.0), "press": (1e-5, 0.0)}),
    "btab": ("bonded_table", "in.test", None, "log.test", "dump.btab",
             {"*": (1e-7, 0.0), "eangle": (1e-7, 1e-7),
              "press": (1e-6, 0.0)}),
    "bq": ("bond_quartic", "in.test", None, "log.test", "dump.bq",
           {"*": (1e-6, 0.0), "epair": (1e-5, 0.0),
            "press": (1e-4, 1e-6)}),
    "class2": ("class2", "in.test", None, "log.test", "dump.class2",
               {"*": (1e-7, 0.0)}),
    "hyb": ("bonded2", "in.hyb", None, None, None,
            {"*": (1e-6, 0.0), "press": (1e-5, 0.0)}),
    "multih": ("bonded2", "in.multih", "dihedral", None, None,
               {"*": (1e-6, 0.0), "press": (1e-5, 0.0)}),
    "opls": ("bonded2", "in.opls", "dihedral", None, None,
             {"*": (1e-6, 0.0), "press": (1e-5, 0.0)}),
    "di": ("dihedral", "in.di", None, None, None,
           {"*": (1e-6, 0.0), "press": (1e-5, 0.0)}),
}
# the reference binary's step-10 rows of the decks without a log in the
# repo (tests/test_bonded2_golden.py:24-69, test_dihedral_golden.py:18-24)
LAST_ROWS = {
    "hyb": {"temp": 359.54147, "epair": -1.2371373, "emol": 1076.9249,
            "etotal": 1190.3624, "press": 220.39869},
    "multih": {"temp": 264.88599, "epair": -1.2366082, "emol": 7799.0451,
               "etotal": 7882.293, "press": 211.72696},
    "opls": {"temp": 260.42785, "epair": -1.2365899, "emol": 34.101806,
             "etotal": 115.92781, "press": 210.92253},
    "di": {"temp": 459.67393, "epair": -1.2369231, "emol": 2069.221,
           "etotal": 2214.5955, "press": 253.90669},
}
# bonds that bond_quartic's deck breaks (tests/test_bond_quartic.py:87-89)
QUARTIC_BROKEN = 2
# dumps at atol DUMP_ATOL * max(1, max|f|); the quartic deck's looser
DUMP_ATOL = {"bq": 1e-8}

# water_shake on the matrix engine: tests/test_golden_water.py:68-92
WATER_SHAKE_TOL = {"temp": (2e-5, 1e-7), "epair": (2e-5, 0.0),
                   "emol": (2e-5, 2e-5), "etotal": (2e-5, 0.0),
                   "press": (2e-4, 0.5), "vol": (1e-6, 0.0)}
WATER_SHAKE_DUMP_ATOL = 2e-4


def stage(gold: str, name: str, where: str) -> str:
    """Copy deck name's golden files into the directory where (the data
    of in.multih and in.opls from dihedral); the deck's path there."""
    d, deck, data, *_ = DECKS[name]
    for src in (d, data):
        if src is None:
            continue
        for f in os.listdir(os.path.join(gold, src)):
            if not (f.startswith("log.") or f.startswith("dump.")):
                shutil.copy(os.path.join(gold, src, f), where)
    return os.path.join(where, deck)


def run(gold: str, name: str, where: str, device, dtype):
    """Deck name verbatim through LammpsScript on device in dtype, staged
    in the directory where (its dump lands there); the script."""
    from tpumd_torch.script.parser import LammpsScript
    path = stage(gold, name, where)
    script = LammpsScript(device=device, dtype=dtype)
    with contextlib.redirect_stdout(sys.stderr):
        script.run_file(path)
    return script


def parse_dump(path: str) -> dict:
    """{step: (n, cols) array sorted by ID} from a text dump."""
    out = {}
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines):
        step, n = int(lines[i + 1]), int(lines[i + 3])
        rows = np.loadtxt(lines[i + 9:i + 9 + n]).reshape(n, -1)
        out[step] = rows[np.argsort(rows[:, 0])]
        i += 9 + n
    return out


def _tol(tols, key):
    return tols.get(key, tols["*"])


def row_failures(what, got: dict, want: dict, tols, printed=False):
    """Keys of the row got outside (rel, abs) of want; with printed, also
    allowed one unit of want's last printed digit."""
    bad = []
    for key, w in want.items():
        rel, ab = _tol(tols, key)
        lim = max(rel * abs(w), ab)
        if printed:
            lim = max(lim, last_digit(repr(w)) * (1 + 1e-9))
        if not abs(got[key] - w) <= lim:
            bad.append(f"{what} {key}: {got[key]!r} vs {w!r}")
    return bad


def log_rows(lines, keys) -> dict:
    """{step: {key: value}} of the first thermo table of a log's lines."""
    return {step: dict(zip(keys, (float(v) for v in toks)))
            for step, toks in printed_rows(lines).items()}


def failures(gold: str, name: str, script, where: str) -> list[str]:
    """What of deck name's run misses the reference binary."""
    d, _, _, log, dump, tols = DECKS[name]
    sim = script.sim
    keys = list(sim.thermo_style)
    bad = []
    if sim._ctx.is_cellgrid:
        bad.append(f"{name}: ran on the cell grid")
    last = {k: float(v) for k, v in sim.last_thermo.items()}
    if log is None:
        bad += row_failures(f"{name} last row", last, LAST_ROWS[name], tols)
    else:
        with open(os.path.join(gold, d, log)) as fh:
            ref = log_rows(fh.read().splitlines(), keys)
        got = log_rows(sim.log_lines, keys)
        if sorted(got) != sorted(ref):
            bad.append(f"{name} steps {sorted(got)} vs {sorted(ref)}")
        final = max(ref)
        for step in sorted(set(got) & set(ref)):
            want = {k: v for k, v in ref[step].items() if k != "step"}
            if step == final:
                bad += row_failures(f"{name} step {step}", last, want, tols)
            else:
                bad += row_failures(f"{name} step {step}", got[step], want,
                                    tols, printed=True)
    if dump is not None:
        bad += dump_failures(name, os.path.join(where, dump),
                             os.path.join(gold, d, dump),
                             DUMP_ATOL.get(name, 1e-9))
    if name == "bq":
        style = sim.bonded["bond"]
        broken = int((~style.alive).sum())
        if broken != QUARTIC_BROKEN:
            bad.append(f"bq: {broken} bonds broken, the reference "
                       f"{QUARTIC_BROKEN}")
    return bad


def dump_failures(what, ours_path, theirs_path, atol) -> list[str]:
    ours, theirs = parse_dump(ours_path), parse_dump(theirs_path)
    bad = []
    if sorted(ours) != sorted(theirs):
        bad.append(f"{what} dump steps {sorted(ours)} vs {sorted(theirs)}")
    for step in sorted(set(ours) & set(theirs)):
        a, b = ours[step], theirs[step]
        scale = max(1.0, float(np.abs(b[:, 1:]).max()))
        err = float(np.abs(a[:, 1:] - b[:, 1:]).max())
        if not np.array_equal(a[:, 0], b[:, 0]) or not err <= atol * scale:
            bad.append(f"{what} dump step {step}: max|df| {err:.3e} > "
                       f"{atol} * {scale:.4g}")
    return bad


def run_water_shake_matrix(gold: str, where: str, device, dtype):
    """tests/golden/water_shake verbatim, forced onto the matrix engine
    (neighbor_mode set between the deck's set-up lines and its run
    line), staged in where; the script."""
    from tpumd_torch.script.parser import LammpsScript
    d = os.path.join(gold, "water_shake")
    shutil.copy(os.path.join(d, "data.water"), where)
    with open(os.path.join(d, "in.test")) as fh:
        pre, runline = fh.read().rsplit("\nrun", 1)
    script = LammpsScript(device=device, dtype=dtype)
    script.data_dir = where
    with contextlib.redirect_stdout(sys.stderr):
        script.run_string(pre)
        script.sim.neighbor_mode = "matrix"
        script.run_string("run" + runline)
    return script


def water_shake_failures(gold: str, script, where: str) -> list[str]:
    """water_shake's run against its log (every row; the last at full
    precision) and its dump, at tests/test_golden_water.py's
    tolerances."""
    sim = script.sim
    d = os.path.join(gold, "water_shake")
    keys = list(sim.thermo_style)
    with open(os.path.join(d, "log.test")) as fh:
        ref = log_rows(fh.read().splitlines(), keys)
    got = log_rows(sim.log_lines, keys)
    bad = [] if not sim._ctx.is_cellgrid else ["water_shake: on the grid"]
    if sorted(got) != sorted(ref):
        bad.append(f"water_shake steps {sorted(got)} vs {sorted(ref)}")
    last = {k: float(v) for k, v in sim.last_thermo.items()}
    tols = {"*": (0.0, math.inf), **WATER_SHAKE_TOL}
    for step in sorted(set(got) & set(ref)):
        want = {k: v for k, v in ref[step].items() if k in WATER_SHAKE_TOL}
        bad += row_failures(f"water_shake step {step}",
                            last if step == max(ref) else got[step], want,
                            tols, printed=step != max(ref))
    return bad + dump_failures("water_shake", os.path.join(
        where, "dump.water"), os.path.join(d, "dump.water"),
        WATER_SHAKE_DUMP_ATOL)
