"""The pair-style goldens: LAMMPS decks whose reference-binary output the
port's pair-style library and kspace are held to, and how each runs.

Eight logs in tests/golden, run verbatim: pair_born, pair_ljexpand and
pair_couldebye (against thermo.csv), pair_table (log.test) and wolfdsf's
in.borndsf, in.bornwolf, in.ljdsf and in.ljwolf (their logs).  Every
printed thermo row of the port equals the reference's to its printed
digits: each value within one unit of the reference's last printed digit
(``failures``; on the CPU in float64 the printed rows are equal as text).

And 21 reference decks whose reference-binary numbers tpumd's own tests
hold (tests/test_pair_misc_golden.py, test_pair_breadth2.py NEUTRAL and
CHARGED with PPPM, test_hybrid.py), copied here with those numbers and
tolerances (``REFERENCE``), so that the CPU tests and the card's check
run the same texts: the last row's temp, epair and etotal at rel 1e-6,
press at 1e-5.
"""

from __future__ import annotations

import math
import os

import numpy as np

# name: (golden directory, input file, reference rows file)
DECKS = {
    "pair_born": ("pair_born", "in.test", "thermo.csv"),
    "pair_ljexpand": ("pair_ljexpand", "in.test", "thermo.csv"),
    "pair_couldebye": ("pair_couldebye", "in.test", "thermo.csv"),
    "pair_table": ("pair_table", "in.test", "log.test"),
    "borndsf": ("wolfdsf", "in.borndsf", "log.borndsf"),
    "bornwolf": ("wolfdsf", "in.bornwolf", "log.bornwolf"),
    "ljdsf": ("wolfdsf", "in.ljdsf", "log.ljdsf"),
    "ljwolf": ("wolfdsf", "in.ljwolf", "log.ljwolf"),
}


def run(gold: str, name: str, device, dtype):
    """Deck name verbatim through LammpsScript on device in dtype, in its
    golden directory (the decks write no files); the script."""
    from tpumd_torch.script.parser import LammpsScript
    d, deck, _ = DECKS[name]
    script = LammpsScript(device=device, dtype=dtype)
    script.run_file(os.path.join(gold, d, deck))
    return script


def printed_rows(lines):
    """{step: [tokens]} of the thermo rows of a log's lines, the first
    table only."""
    rows, active = {}, False
    for ln in lines:
        p = ln.split()
        if p and p[0] == "Step":
            if rows:
                break
            active = True
            continue
        if active:
            if not p or not p[0].lstrip("-").isdigit():
                if rows:
                    break
                continue
            rows[int(p[0])] = p
    return rows


def reference_rows(gold: str, name: str):
    """{step: [tokens]} of the reference binary's rows of deck name; a
    csv's values are the log's printed numbers."""
    d, _, ref = DECKS[name]
    path = os.path.join(gold, d, ref)
    if ref.endswith(".csv"):
        return {int(r[0]): [repr(float(v)) for v in r]
                for r in np.loadtxt(path, ndmin=2)}
    with open(path) as fh:
        return printed_rows(fh.read().splitlines())


def last_digit(token: str) -> float:
    """One unit of the last printed digit of a %g-printed number (8
    significant digits as LAMMPS prints them)."""
    v = float(token)
    if v == 0.0:
        return 1e-300
    return 10.0 ** (math.floor(math.log10(abs(v))) - 7)


def failures(gold: str, name: str, script) -> list[str]:
    """What of deck name's printed rows disagrees with the reference's:
    each value must lie within one unit of the reference's last printed
    digit of it."""
    ref = reference_rows(gold, name)
    got = printed_rows(script.sim.log_lines)
    bad = []
    if sorted(got) != sorted(ref):
        bad.append(f"{name} steps {sorted(got)} vs {sorted(ref)}")
    for step in sorted(set(got) & set(ref)):
        g, w = got[step], ref[step]
        if len(g) != len(w):
            bad.append(f"{name} step {step}: {g} vs {w}")
            continue
        for c, (a, b) in enumerate(zip(g, w)):
            if abs(float(a) - float(b)) > last_digit(b) * (1 + 1e-9):
                bad.append(f"{name} step {step} column {c}: {a} vs {b}")
    return bad


def equal_as_printed(gold: str, name: str, script) -> bool:
    """The port's printed rows equal the reference's values as printed."""
    ref = reference_rows(gold, name)
    got = printed_rows(script.sim.log_lines)
    return sorted(got) == sorted(ref) and all(
        [float(v) for v in got[s]] == [float(v) for v in ref[s]]
        for s in ref)


# ---------------------------------------------------------------------------
# the reference decks of tpumd's tests, with the reference binary's numbers

MISC_DECK = """
units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.44 87287 loop geom
pair_style {ps}
pair_coeff 1 1 {coeff}
neighbor 0.3 bin
neigh_modify delay 0 every 5 check no
fix 1 all nve
thermo 10
run 10
"""

CHARGED_DECK = """
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
mass 2 1.0
velocity all create 1.44 87287 loop geom
pair_style {ps}
{coeffs}
{kspace}neighbor 0.3 bin
neigh_modify delay 0 every 5 check no
fix 1 all nve
thermo 10
run 10
"""

HYBRID_OVERLAY_DECK = """
units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 4
region left block 0 1.9 0 4 0 4
region right block 1.95 4 0 4 0 4
create_box 2 box
create_atoms 1 region left
create_atoms 2 region right
mass * 1.0
velocity all create 1.44 87287 loop geom
pair_style hybrid/overlay lj/cut 2.5 morse 2.5
pair_coeff 1 1 lj/cut 1.0 1.0 2.5
pair_coeff 1 2 lj/cut 1.0 1.0 2.5
pair_coeff 2 2 lj/cut 0.8 1.05 2.5
pair_coeff 1 2 morse 0.2 2.0 1.1
neighbor 0.3 bin
neigh_modify delay 0 every 5 check no
fix 1 all nve
thermo 10
run 10
"""

PPPM = "kspace_style pppm 1e-4\n"


def _misc(ps, coeff):
    return MISC_DECK.format(ps=ps, coeff=coeff)


def _charged(ps, coeffs, kspace=""):
    return CHARGED_DECK.format(ps=ps, coeffs=coeffs, kspace=kspace)


# name: (deck, (temp, epair, etotal, press) at step 10 from the reference
# binary): tests/test_pair_misc_golden.py:24-35, test_pair_breadth2.py:
# 54-103, test_hybrid.py
REFERENCE = {
    "morse": (_misc("morse 2.5", "0.5 1.3 1.1 2.5"),
              (1.4191326, -7.996779, -5.8763954, -2.1437836)),
    "buck": (_misc("buck 2.5", "1000.0 0.3 1.5"),
             (0.57290088, 138.01102, 138.86701, 168.85224)),
    "yukawa": (_misc("yukawa 1.2 2.5", "2.0"),
               (1.4247414, 4.2059177, 6.3346817, 4.5441673)),
    "soft": (_misc("soft 2.5", "1.0"),
             (1.4362572, 9.8179689, 11.963939, 10.53444)),
    "zbl": (_misc("zbl 1.5 2.0", "29 29"),
            (0.9156246, 24.914491, 26.282563, 38.360406)),
    "nm/cut": (_misc("nm/cut 2.5", "1.0 1.12 10 5"),
               (1.2109563, -7.4039739, -5.5946349, -3.4268538)),
    "mie/cut": (_misc("mie/cut 2.5", "1.0 1.0 14 7"),
                (1.1696021, -5.3091742, -3.5616242, -2.8425779)),
    "lj/gromacs": (_misc("lj/gromacs 2.0 2.5", "1.0 1.0"),
                   (1.1321367, -5.5908843, -3.8993128, -2.4161031)),
    "lj/smooth/linear": (_misc("lj/smooth/linear 2.5", "1.0 1.0"),
                         (1.1317617, -5.2336186, -3.5426075, -2.0425754)),
    "harmonic/cut": (_misc("harmonic/cut", "2.0 1.5"),
                     (1.4132878, 1.2106342, 3.3222849, 3.611114)),
    "lj/class2": (_misc("lj/class2 2.5", "1.0 1.0"),
                  (1.4484204, -4.7520961, -2.5879524, -4.1111104)),
    "coul/dsf": (_charged("coul/dsf 0.8 2.5", "pair_coeff * *"),
                 (1.4377457, 0.045044763, 2.1932391, 1.3943531)),
    "coul/wolf": (_charged("coul/wolf 0.8 2.5", "pair_coeff * *"),
                  (1.4377457, 0.063789905, 2.2119842, 1.3943531)),
    "coul/long": (_charged("coul/long 2.5", "pair_coeff * *", PPPM),
                  (1.4370883, 0.83642479, 2.9836368, 1.4566789)),
    "buck/coul/cut": (_charged("buck/coul/cut 2.5",
                               "pair_coeff * * 100.0 0.5 1.0"),
                      (1.3144026, 90.545199, 92.509101, 73.827458)),
    "buck/coul/long": (_charged("buck/coul/long 2.5",
                                "pair_coeff * * 100.0 0.5 1.0", PPPM),
                       (1.3135829, 89.534065, 91.496742, 73.552026)),
    "born/coul/long": (_charged("born/coul/long 2.5",
                                "pair_coeff * * 10.0 0.4 1.0 1.0 0.5", PPPM),
                       (1.1862023, 53.023826, 54.796179, 52.307971)),
    "lj/class2/coul/cut": (_charged("lj/class2/coul/cut 2.5",
                                    "pair_coeff * * 1.0 1.0"),
                           (1.4464901, -2.9043117, -0.74305213,
                            -3.5922843)),
    "lj/class2/coul/long": (_charged("lj/class2/coul/long 2.5",
                                     "pair_coeff * * 1.0 1.0", PPPM),
                            (1.4453105, -3.9154237, -1.7559266,
                             -3.8648329)),
    "hybrid/overlay": (HYBRID_OVERLAY_DECK,
                       (1.0555844, -6.4562531, -4.8790615, -1.307234)),
    "hybrid/scaled": (_misc("hybrid/scaled 0.7 lj/cut 2.5 0.5 morse 2.5",
                            "lj/cut 1.0 1.0 2.5\npair_coeff 1 1 morse 0.5 "
                            "1.3 1.1 2.5"),
                      (1.2038164, -8.4014839, -6.6028129, -3.0784891)),
}

# the tolerances of tpumd's tests: (temp, epair, etotal) and press
REFERENCE_RTOL = (1e-6, 1e-5)


def reference_failures(name: str, row: dict) -> list[str]:
    """What of the last thermo row of reference deck name misses the
    reference binary's numbers."""
    want = REFERENCE[name][1]
    bad = []
    for key, w, rel in zip(("temp", "epair", "etotal", "press"), want,
                           (REFERENCE_RTOL[0],) * 3 + (REFERENCE_RTOL[1],)):
        if not abs(row[key] - w) <= rel * abs(w):
            bad.append(f"{name} {key}: {row[key]!r} vs {w!r}")
    return bad
