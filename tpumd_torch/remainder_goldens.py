"""The goldens of the output and input remainders and of the NEMD and
reactive fixes: LAMMPS decks whose reference-binary output the port's
molecule templates, local computes, dump local/cfg/grid/binary, fix
ave/grid, NEMD fixes and fix bond/break and bond/create are held to.

Each deck runs verbatim, staged in a directory of its own where its dumps
land.  ``failures`` holds a run to the reference binary's files where
tpumd's own tests of the deck do, at their tolerances
(tests/test_create_mol.py, test_dump_local.py, test_ave_grid.py,
test_bindump.py, test_nemd.py, test_bond_break.py, test_bond_create.py):
the last thermo row, the dumped local rows (2e-5), the CFG snapshots
token by token (2e-5), the grid frames (1e-5), the binary dump (every
header byte, the step-0 snapshot byte for byte, the later one's data to
1e-12: its positions differ from the reference's in the last bits, as the
force sums' order does) and the force dumps of the bond fixes (1e-9 of the
largest force).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import struct
import sys

import numpy as np

from tpumd_torch.bonded_goldens import dump_failures, log_rows, \
    row_failures

_T7 = (1e-7, 1e-10)
# name: (golden directory, deck, log or None, {thermo key: (rel, abs)} of
# the last row)
DECKS = {
    "create_mol": ("create_mol", "in.createmol", "log.ref",
                   dict.fromkeys(("temp", "epair", "emol", "etotal",
                                  "press"), (1e-7, 0.0))),
    "dump_local": ("dump_local", "in.dl", "log.dl", {}),
    "ave_grid": ("ave_grid", "in.ag", "log.ag", {}),
    "bindump": ("bindump", "in.test", None, {}),
    "nemd_tc": ("nemd", "in.tc", "log.tc",
                dict.fromkeys(("temp", "epair", "etotal", "f_2"), _T7)),
    "nemd_visc": ("nemd", "in.visc", "log.visc",
                  dict.fromkeys(("temp", "epair", "etotal", "f_2"), _T7)),
    "nemd_heat": ("nemd", "in.heat", "log.heat",
                  dict.fromkeys(("temp", "epair", "etotal", "press"), _T7)),
    "nemd_misc": ("nemd", "in.misc", "log.misc",
                  dict.fromkeys(("temp", "epair", "etotal", "press"), _T7)),
    "bond_break": ("bond_break", "in.test", "log.test",
                   {"temp": (1e-7, 0.0), "ebond": (1e-6, 0.0),
                    "epair": (1e-6, 0.0), "etotal": (1e-7, 0.0),
                    "press": (1e-6, 0.0)}),
    "bond_create": ("bond_create", "in.test", "log.test",
                    {"temp": (1e-7, 0.0), "ebond": (1e-6, 0.0),
                     "epair": (1e-6, 0.0), "etotal": (1e-7, 0.0)}),
}
# the files each deck writes, held to the reference's copy: (ours, the
# reference's, kind)
FILES = {
    "dump_local": (("dump.local", "dump.local", "local"),
                   ("dump.angle", "dump.angle", "local"),
                   ("dump.cfg.0", "dump.cfg.0", "cfg"),
                   ("dump.cfg.5", "dump.cfg.5", "cfg")),
    "ave_grid": (("dump.grid", "dump.grid", "grid"),),
    "bindump": (("dump.bin", "dump.ref.bin", "bin"),),
    "bond_break": (("dump.bbrk", "dump.bbrk", "forces"),),
    "bond_create": (("dump.bcr", "dump.bcr", "forces"),),
}
# what the bond fixes leave: (live bonds, special entries)
BONDS_LEFT = {"bond_break": (2, 4), "bond_create": (1, 2)}


def stage(gold: str, name: str, where: str) -> str:
    """Copy deck name's input files into the directory where; the deck's
    path there."""
    d, deck = DECKS[name][:2]
    for f in os.listdir(os.path.join(gold, d)):
        if not (f.startswith("log.") or f.startswith("dump.")):
            shutil.copy(os.path.join(gold, d, f), where)
    return os.path.join(where, deck)


def run(gold: str, name: str, where: str, device, dtype):
    """Deck name verbatim through LammpsScript on device in dtype, staged
    in the directory where (its dumps land there); the script."""
    from tpumd_torch.script.parser import LammpsScript
    path = stage(gold, name, where)
    script = LammpsScript(device=device, dtype=dtype)
    with contextlib.redirect_stdout(sys.stderr):
        script.run_file(path)
    return script


def _frames(path, head, count):
    """{step: rows} of a dump whose snapshots have head header lines and
    count(header lines) rows."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    out, i = {}, 0
    while i < len(lines):
        n = count(lines[i:i + head])
        out[int(lines[i + 1])] = np.array(
            [[float(v) for v in ln.split()]
             for ln in lines[i + head:i + head + n]]).reshape(n, -1)
        i += head + n
    return out


def _close(what, a, b, rtol, atol):
    if a.shape != b.shape:
        return [f"{what}: shape {a.shape} vs {b.shape}"]
    err = np.abs(a - b) - (atol + rtol * np.abs(b))
    if err.size and err.max() > 0:
        return [f"{what}: max|d| {np.abs(a - b).max():.3e} past {rtol}, "
                f"{atol}"]
    return []


def _cfg_failures(what, ours, ref):
    with open(ours) as fh:
        a = fh.read().splitlines()
    with open(ref) as fh:
        b = fh.read().splitlines()
    if len(a) != len(b):
        return [f"{what}: {len(a)} lines vs {len(b)}"]
    for la, lb in zip(a, b):
        ta, tb = la.split(), lb.split()
        if len(ta) != len(tb):
            return [f"{what}: {la!r} vs {lb!r}"]
        for x, y in zip(ta, tb):
            try:
                fy = float(y)
            except ValueError:
                if x != y:
                    return [f"{what}: {la!r} vs {lb!r}"]
                continue
            if abs(float(x) - fy) > 2e-5 * max(abs(fy), 1e-3):
                return [f"{what}: {la!r} vs {lb!r}"]
    return []


def read_binary(path):
    """[(header bytes, column data (n, size) float64, data bytes)] of each
    snapshot of a binary dump (DumpAtom::header_binary)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    out, i = [], 0
    while i < len(raw):
        start = i
        (m,) = struct.unpack_from("<q", raw, i)
        i += 8 - m + 8 + 16
        (tri,) = struct.unpack_from("<i", raw, i)
        i += 4 + 24 + 48 + (24 if tri else 0)
        size, ulen = struct.unpack_from("<ii", raw, i)
        i += 8 + ulen
        (tflag,) = struct.unpack_from("<b", raw, i)
        i += 1 + (8 if tflag else 0)
        (clen,) = struct.unpack_from("<i", raw, i)
        i += 4 + clen
        _, nval = struct.unpack_from("<ii", raw, i)
        i += 8
        data = raw[i:i + 8 * nval]
        out.append((raw[start:i],
                    np.frombuffer(data, "<f8").reshape(-1, size), data))
        i += 8 * nval
    return out


def _binary_failures(what, ours, ref):
    a, b = read_binary(ours), read_binary(ref)
    if len(a) != len(b):
        return [f"{what}: {len(a)} snapshots vs {len(b)}"]
    bad = []
    for k, ((ha, da, ba), (hb, db, bb)) in enumerate(zip(a, b)):
        if ha != hb:
            bad.append(f"{what} snapshot {k}: header bytes differ")
        if k == 0 and ba != bb:
            bad.append(f"{what} snapshot 0: data bytes differ")
        if da.shape != db.shape or not np.array_equal(da[:, :2], db[:, :2]):
            bad.append(f"{what} snapshot {k}: ids or types differ")
        else:
            bad += _close(f"{what} snapshot {k}", da[:, 2:], db[:, 2:], 0.0,
                          1e-12)
    return bad


def file_failures(gold: str, name: str, where: str) -> list[str]:
    """What of deck name's written files misses the reference's."""
    d = os.path.join(gold, DECKS[name][0])
    bad = []
    for ours, ref, kind in FILES.get(name, ()):
        a, b = os.path.join(where, ours), os.path.join(d, ref)
        what = f"{name} {ours}"
        if kind == "local":
            fa, fb = (_frames(p, 9, lambda h: int(h[3])) for p in (a, b))
            if sorted(fa) != sorted(fb):
                bad.append(f"{what}: steps {sorted(fa)} vs {sorted(fb)}")
            for step in sorted(set(fa) & set(fb)):
                bad += _close(f"{what} step {step}", fa[step], fb[step],
                              2e-5, 1e-7)
        elif kind == "grid":
            fa, fb = (_frames(p, 11, lambda h: int(np.prod(
                [int(v) for v in h[9].split()]))) for p in (a, b))
            if sorted(fa) != sorted(fb):
                bad.append(f"{what}: steps {sorted(fa)} vs {sorted(fb)}")
            for step in sorted(set(fa) & set(fb)):
                bad += _close(f"{what} step {step}", fa[step], fb[step],
                              1e-5, 1e-8)
        elif kind == "cfg":
            bad += _cfg_failures(what, a, b)
        elif kind == "bin":
            bad += _binary_failures(what, a, b)
        else:
            bad += dump_failures(what, a, b, 1e-9)
    return bad


def failures(gold: str, name: str, script, where: str) -> list[str]:
    """What of golden name's run misses the reference binary."""
    d, _, log, tols = DECKS[name]
    sim = script.sim
    bad = []
    if log is not None and tols:
        with open(os.path.join(gold, d, log)) as fh:
            ref = log_rows(fh.read().splitlines(), list(sim.thermo_style))
        final = max(ref)
        if sim.step != final:
            bad.append(f"{name}: ended at step {sim.step}, the log at "
                       f"{final}")
        last = {k: float(v) for k, v in sim.last_thermo.items()}
        bad += row_failures(f"{name} step {final}", last,
                            {k: ref[final][k] for k in tols},
                            {"*": (0.0, 0.0), **tols})
    bad += file_failures(gold, name, where)
    if name in BONDS_LEFT:
        nb = len(sim.live_topology("bond"))
        ns = int((sim._carry[0].special_tags > 0).sum())
        if (nb, ns) != BONDS_LEFT[name]:
            bad.append(f"{name}: {nb} bonds and {ns} special entries, the "
                       f"reference {BONDS_LEFT[name]}")
    return bad
