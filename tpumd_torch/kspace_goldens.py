"""The DPD and kspace goldens: LAMMPS decks whose reference-binary output
the port's DPD, TIP4P, MSM, pppm/disp, pppm/stagger and ewald/disp are held
to, and two water decks of the other PPPM variants.

Six decks of tests/golden run verbatim, each staged in a directory of its
own (pppm_stagger writes its dump there): dpd's in.dpd_cons, tip4p's,
msm's, pppm_stagger's and ewald_disp's in.test, and pppm_disp's in.test and
in.mesh.  ``failures`` holds a run to the reference binary where tpumd's
tests of the same deck do (tests/test_dpd.py, test_tip4p.py, test_msm.py,
test_pppm_disp.py, test_pppm_stagger.py, test_ewald_disp.py), at their
tolerances: the solver's parameters (``PARAMS``), the last thermo row and
pppm_stagger's dumped forces at atol 2e-4 x max(1, max|f|).

``VARIANTS``: pppm_stagger's water deck with ``kspace_style pppm`` and
``kspace_modify diff ad``, and with ``kspace_style pppm/cg``, its dump
left out.  They have no reference file; the CPU tests hold them to tpumd's
rows and the card to the CPU's.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys

from tpumd_torch.bonded_goldens import dump_failures, log_rows, \
    row_failures

# name: (golden directory, deck, log, dump or None, {thermo key: (rel,
# abs)}: the keys of the last row that tpumd's test checks)
DECKS = {
    "dpd": ("dpd", "in.dpd_cons", "log.dpd_cons", None,
            {"temp": (1e-8, 0.0), "epair": (1e-8, 0.0),
             "etotal": (1e-8, 0.0), "press": (1e-7, 0.0)}),
    "tip4p": ("tip4p", "in.test", "log.ref", None,
              {"temp": (1e-6, 0.0), "epair": (1e-5, 0.0),
               "emol": (1e-5, 0.0), "etotal": (1e-5, 0.0),
               "press": (5e-3, 0.0)}),
    "msm": ("msm", "in.test", "log.ref", None,
            {"elong": (2e-6, 0.0), "temp": (1e-4, 0.0),
             "epair": (2e-4, 0.0), "etotal": (3e-5, 0.0),
             "press": (2e-3, 0.0)}),
    "pppm_disp": ("pppm_disp", "in.test", "log.ref", None,
                  {"temp": (1e-5, 0.0), "evdwl": (1e-4, 0.0),
                   "ecoul": (1e-5, 0.0), "elong": (1e-6, 0.0),
                   "etotal": (1e-4, 0.0), "press": (1e-4, 0.0)}),
    "pppm_disp_mesh": ("pppm_disp", "in.mesh", "log.mesh", None,
                       {"temp": (1e-5, 0.0), "evdwl": (1e-4, 0.0),
                        "elong": (1e-6, 0.0), "etotal": (1e-4, 0.0),
                        "press": (1e-4, 0.0)}),
    "pppm_stagger": ("pppm_stagger", "in.test", "log.test", "dump.stagger",
                     {"temp": (1e-6, 0.0), "epair": (1e-5, 0.0),
                      "emol": (1e-5, 1e-8), "etotal": (1e-5, 0.0),
                      "press": (1e-3, 0.05), "vol": (1e-12, 0.0)}),
    "ewald_disp": ("ewald_disp", "in.test", "log.ref", None,
                   {"elong": (1e-6, 0.0), "evdwl": (1e-5, 0.0),
                    "ecoul": (1e-5, 0.0), "temp": (1e-5, 0.0),
                    "etotal": (1e-4, 0.0), "press": (5e-3, 0.0)}),
}
# the solvers' parameters against the reference logs' headers, as tpumd's
# tests hold them: a float's (value, rel), else the exact value
PARAMS = {
    "msm": {"ngrids0": (8, 8, 8), "order": 10, "levels": 3},
    "pppm_disp": {"g_ewald": (0.3845265861948978, 1e-7),
                  "mesh": (15, 15, 15),
                  "g_ewald_6": (0.2259063588304604, 1e-10),
                  "n6": (2, 2, 2)},
    "pppm_disp_mesh": {"g_ewald_6": (0.3726782264787978, 1e-10),
                       "n6": (12, 12, 12)},
    "pppm_stagger": {"g_ewald": (0.3841898, 1e-6), "mesh": (12, 12, 12)},
    "ewald_disp": {"g_ewald": (0.36199972, 1e-6)},
}
DUMP_ATOL = 2e-4

# the other PPPM variants on pppm_stagger's water deck: name -> the kspace
# lines in place of its kspace_style line
VARIANTS = {
    "pppm_ad": "kspace_style pppm 1e-4\nkspace_modify diff ad",
    "pppm_cg": "kspace_style pppm/cg 1e-4",
}


def stage(gold: str, d: str, where: str):
    """Copy golden directory d's input files into the directory where."""
    for f in os.listdir(os.path.join(gold, d)):
        if not (f.startswith("log.") or f.startswith("dump.")):
            shutil.copy(os.path.join(gold, d, f), where)


def deck_text(gold: str, name: str) -> str:
    """The deck of name: a golden's verbatim, a variant's edited."""
    d, deck = ("pppm_stagger", "in.test") if name in VARIANTS \
        else DECKS[name][:2]
    with open(os.path.join(gold, d, deck)) as fh:
        text = fh.read()
    if name in VARIANTS:
        lines = [ln for ln in text.splitlines()
                 if not ln.startswith(("dump", "kspace_style"))]
        at = next(i for i, ln in enumerate(lines)
                  if ln.startswith("special_bonds"))
        text = "\n".join(lines[:at] + [VARIANTS[name]] + lines[at:]) + "\n"
    return text


def run(gold: str, name: str, where: str, device, dtype, steps=None):
    """Deck name through LammpsScript on device in dtype, staged in the
    directory where (its dump lands there); with steps, its run line
    replaced by ``run steps``.  Returns the script."""
    from tpumd_torch.script.parser import LammpsScript
    d = "pppm_stagger" if name in VARIANTS else DECKS[name][0]
    stage(gold, d, where)
    text = deck_text(gold, name)
    if steps is not None:
        text = text.rsplit("\nrun", 1)[0] + f"\nrun {steps}\n"
    script = LammpsScript(device=device, dtype=dtype)
    script.data_dir = where
    with contextlib.redirect_stdout(sys.stderr):
        script.run_string(text)
    return script


def params(sim) -> dict:
    """The kspace solver's parameters that PARAMS names."""
    ks = sim.kspace
    out = {}
    for key in ("g_ewald", "g_ewald_6", "order", "levels"):
        if hasattr(ks, key):
            out[key] = getattr(ks, key)
    if hasattr(ks, "nx"):
        out["mesh"] = (ks.nx, ks.ny, ks.nz)
    if hasattr(ks, "n6"):
        out["n6"] = tuple(ks.n6)
    if hasattr(ks, "ngrids"):
        out["ngrids0"] = tuple(ks.ngrids[0])
    return out


def failures(gold: str, name: str, script, where: str) -> list[str]:
    """What of golden name's run misses the reference binary."""
    d, _, log, dump, tols = DECKS[name]
    sim = script.sim
    bad = []
    got = params(sim)
    for key, want in PARAMS.get(name, {}).items():
        if isinstance(want, tuple) and isinstance(want[0], float):
            ok = abs(got.get(key, float("nan")) - want[0]) <= want[1] * abs(
                want[0])
        else:
            ok = got.get(key) == want
        if not ok:
            bad.append(f"{name} {key}: {got.get(key)!r} vs {want!r}")
    keys = list(sim.thermo_style)
    with open(os.path.join(gold, d, log)) as fh:
        ref = log_rows(fh.read().splitlines(), keys)
    final = max(ref)
    if sim.step != final:
        bad.append(f"{name}: ended at step {sim.step}, the log at {final}")
    last = {k: float(v) for k, v in sim.last_thermo.items()}
    want = {k: v for k, v in ref[final].items() if k in tols}
    bad += row_failures(f"{name} step {final}", last, want,
                        {"*": (0.0, 0.0), **tols})
    if dump is not None:
        bad += dump_failures(name, os.path.join(where, dump),
                             os.path.join(gold, d, dump), DUMP_ATOL)
    return bad
