"""The analysis goldens: six decks of tests/golden whose reference-binary
output the port's analysis layer is held to, how each runs verbatim, and
the comparison of every file it writes with the reference's.

computes (rdf, coord/atom, cluster/atom, displace/atom, group/group,
heat/flux, ke/pe/stress/atom, fix ave/time mode vector into rdf.out, a
dump of per-atom computes), temp_variants (temp/com, temp/partial,
temp/region), struct_computes (cna/atom, centro/atom, orientorder/atom
into dump.struct), store_histo (store/state, ave/histo, property/atom,
set d_/i_), chunk_family (13 chunk computes, 9 ave/time files) and dipole
(dipole, dipole/chunk).  The tolerances are those of tpumd's own golden
tests (tests/test_computes_golden.py, test_struct_computes.py,
test_store_histo.py, test_compute_chunk.py, test_dipole.py): the files
print 6 significant digits, and the coul/long decks drift ~1e-7 from the
reference's tabulated erfc by step 10.  ``failures`` returns what
disagrees, empty when all agree; the CPU tests and the card's check both
call it.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

# deck directory: (input file, files it reads from another golden)
DECKS = {
    "computes": ("in.test", ()),
    "temp_variants": ("in.tv", ()),
    "struct_computes": ("in.test", ()),
    "store_histo": ("in.test", ()),
    "chunk_family": ("in.chk", ()),
    "dipole": ("in.dip", (("water_nve", "data.water"),)),
}

# thermo columns held to the reference log: {deck: (log, {column: rel})}
THERMO = {
    "computes": ("thermo.csv", {1: 1e-6, 2: 1e-6, 3: 1e-5}),
    "temp_variants": ("log.tv", {1: 1e-6, 2: 1e-6, 3: 1e-6, 4: 1e-6}),
    "dipole": ("log.dip", {2: 1e-6, 3: 1e-6, 4: 1e-6, 5: 1e-6}),
    "chunk_family": ("log.chk", {1: 1e-6, 4: 1e-9, 5: 2e-5, 6: 2e-4,
                                 7: 2e-5, 8: 1e-2}),
}
# the computes deck's small columns, at the last row: {col: (rel, abs)}
SMALL = {4: (1e-4, 1e-7), 5: (1e-4, 1e-6), 6: (1e-4, 1e-6)}

# dumps: {deck: (file, per-column (rtol, atol) after the id column)}
DUMPS = {
    "computes": ("dump.cmp", [(0, 1e-9), (0, 1e-9), (1e-5, 1e-9)]),
    "struct_computes": ("dump.struct", [(0, 0), (1e-5, 1e-9)]
                        + [(1e-5, 1e-7)] * 5),
    "store_histo": ("dump.ss", [(1e-5, 1e-9)] * 4),
}

# fix ave/time mode vector files
VECTOR_FILES = {
    "computes": ("rdf.out",),
    "chunk_family": ("out.com", "out.vcm", "out.gyr", "out.tmp", "out.ang",
                     "out.trq", "out.ine", "out.omg", "out.msd"),
    "dipole": ("out.chunk",),
}


def run(gold: str, name: str, dest: str, device, dtype):
    """Copy deck name's input and data files (not the reference's outputs)
    from the golden directory gold into dest and run it there through
    LammpsScript on device in dtype; the script."""
    from tpumd_torch.script.parser import LammpsScript
    src = os.path.join(gold, name)
    for f in os.listdir(src):
        if f.startswith(("in.", "data.")):
            shutil.copy(os.path.join(src, f), dest)
    for other, f in DECKS[name][1]:
        shutil.copy(os.path.join(gold, other, f), dest)
    script = LammpsScript(device=device, dtype=dtype)
    script.run_file(os.path.join(dest, DECKS[name][0]))
    return script


def thermo_rows(path):
    """{step: row} of the first thermo table of a LAMMPS log (nan where it
    printed nan), or of a csv of rows."""
    if path.endswith(".csv"):
        return {int(r[0]): list(r) for r in np.loadtxt(path)}
    rows, active = {}, False
    for ln in open(path).read().splitlines():
        p = ln.split()
        if p and p[0] == "Step":
            active = True
            continue
        if active:
            if not p or not p[0].lstrip("-").isdigit():
                if rows:
                    break
                continue
            rows[int(p[0])] = [np.nan if "nan" in v else float(v) for v in p]
    return rows


def read_dump(path):
    """{step: rows sorted by id} of a text dump."""
    frames, lines, i = {}, open(path).read().splitlines(), 0
    while i < len(lines):
        step, n = int(lines[i + 1]), int(lines[i + 3])
        rows = np.array([[float(v) for v in ln.split()]
                         for ln in lines[i + 9:i + 9 + n]])
        frames[step] = rows[np.argsort(rows[:, 0])]
        i += 9 + n
    return frames


def read_vector_file(path):
    """{step: (rows, cols)} of a fix ave/time mode vector file."""
    out, i = {}, 0
    lines = [ln for ln in open(path) if not ln.startswith("#")]
    while i < len(lines):
        step, nrows = (int(v) for v in lines[i].split())
        out[step] = np.array([[float(v) for v in lines[i + 1 + k].split()[1:]]
                              for k in range(nrows)])
        i += 1 + nrows
    return out


def read_histo(path):
    """(header numbers, bin rows) of a fix ave/histo file's one block."""
    header, rows = None, []
    for ln in open(path):
        if ln.startswith("#"):
            continue
        parts = [float(v) for v in ln.split()]
        if header is None:
            header = parts
        else:
            rows.append(parts)
    return np.asarray(header), np.asarray(rows)


def headers(path):
    return [ln for ln in open(path) if ln.startswith("#")]


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and bool(
        np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def failures(gold: str, name: str, script) -> list[str]:
    """What of deck name's output (written in script.data_dir, its rows in
    script.sim) disagrees with the reference's files in gold/name."""
    bad = []
    ref_dir, out_dir = os.path.join(gold, name), script.data_dir
    if name in THERMO:
        log, cols = THERMO[name]
        ref = thermo_rows(os.path.join(ref_dir, log))
        width = len(next(iter(ref.values())))
        got = {}
        for ln in script.sim.log_lines:
            p = ln.split()
            if p and p[0].isdigit() and len(p) == width:
                got[int(p[0])] = [float(v) for v in p]
        if sorted(got) != sorted(ref):
            bad.append(f"{name} thermo steps {sorted(got)}")
        for step in set(got) & set(ref):
            for c, tol in cols.items():
                w = ref[step][c]
                if np.isfinite(w) and not _close(got[step][c], w, tol,
                                                 1e-6):
                    bad.append(f"{name} step {step} column {c}: "
                               f"{got[step][c]!r} vs {w!r}")
        if name == "computes":
            last = ref[max(ref)]
            for c, (rel, tol) in SMALL.items():
                if not _close(got[max(got)][c], last[c], rel, tol):
                    bad.append(f"computes column {c}: {got[max(got)][c]!r}"
                               f" vs {last[c]!r}")
    if name in DUMPS:
        fname, tols = DUMPS[name]
        ref = read_dump(os.path.join(ref_dir, fname))
        got = read_dump(os.path.join(out_dir, fname))
        if sorted(got) != sorted(ref):
            bad.append(f"{name} {fname} steps {sorted(got)}")
        for step in set(got) & set(ref):
            g, w = got[step], ref[step]
            if g.shape != w.shape or not np.array_equal(g[:, 0], w[:, 0]):
                bad.append(f"{name} {fname} step {step}: rows")
                continue
            for c, (rtol, atol) in enumerate(tols, 1):
                if not _close(g[:, c], w[:, c], rtol, atol):
                    err = np.abs(g[:, c] - w[:, c]).max()
                    bad.append(f"{name} {fname} step {step} column {c}: "
                               f"max error {err:.3g}")
    if name == "store_histo":
        path = os.path.join(out_dir, "out.histo")
        hd_ref, rows_ref = read_histo(os.path.join(ref_dir, "out.histo"))
        hd, rows = read_histo(path)
        if not (_close(hd, hd_ref, 2e-6, 1e-12)
                and _close(rows, rows_ref, 2e-6, 1e-9)
                and headers(path) == headers(os.path.join(ref_dir,
                                                          "out.histo"))):
            bad.append("store_histo out.histo")
    for fname in VECTOR_FILES.get(name, ()):
        ref_path, got_path = (os.path.join(ref_dir, fname),
                              os.path.join(out_dir, fname))
        if headers(got_path) != headers(ref_path):
            bad.append(f"{name} {fname} header")
        ref, got = read_vector_file(ref_path), read_vector_file(got_path)
        if sorted(got) != sorted(ref):
            bad.append(f"{name} {fname} steps {sorted(got)}")
            continue
        for step in ref:
            w = ref[step]
            if name == "computes":
                # bin centres to 1e-9, g(r) and coord(r) to the digits
                ok = (_close(got[step][:, :1], w[:, :1], 1e-9, 0)
                      and _close(got[step][:, 1:], w[:, 1:], 2e-5, 1e-8))
            else:
                scale = max(1.0, float(np.abs(w).max()))
                ok = _close(got[step], w, 2e-5,
                            (1e-5 if step == 0 else 5e-5) * scale)
            if not ok:
                bad.append(f"{name} {fname} step {step}")
    return bad
