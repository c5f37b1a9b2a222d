"""Lanes per atom of the pair list sweeps and lanes per slot of the list
build on the card: gran/hooke/history (B6), LJ+FENE (B2), lj/cut (B1),
the EAM density and force passes (B3, B4) and the build.

Run from the repository root: ``python3 probes/pairlist_lanes.py``.
Builds a copy of each kernel's source for each lanes per atom it is
tried at (B6 and B2: 1, 2, 4 and 8; B1 and B4: 4, 8, 16 and 32; B3: 2, 4,
8 and 16; the build's wide G: 4, 8, 16 and 32), its lanes constant
(``kLanes`` of ``tpumd_torch/csrc/gran_cellgrid.cu`` and
``lj_fene_cellgrid.cu``, ``kLanesLJ`` of the latter, ``kLanesRho`` and
``kLanesEAM`` of ``eam_cellgrid.cu``, ``kLanesBuild`` of
``cellgrid_pairlist.cu``) rewritten in the copy (the package keeps one
value), all with one nvcc each at once, into ``build/pairlist_lanes/``.
Sets up the 32,000-sphere chute deck (f32, 10 steps, so the contact
history is live), the 32,000-atom chain deck (f32, set-up), the in.lj
and in.eam decks (f32, 10 steps: on their lattices the forces cancel)
and the 32,064-atom rhodo_class deck (f32, set-up), each with its pair
list built by the list kernel; holds each sweep variant's outputs
against the plain list sweep (forces, torques, densities and virial to
2e-6 of their largest, energies to 2e-6 relative, history tags equal)
and each build variant's list, forced to its wide G on rhodo_class's
grid, against the plain build (live entries as arrays, counts, longest
row), and times the launch the main path makes most (B6 with
shearupdate, the others forces or densities only, the build as a re-bin
launches it, its hold made beforehand) with ``chip_smoke.cuda_ms`` (CUDA
events around 200 launches, 50 for the build, queued behind a spin
kernel, so that the card runs them back to back), in the order of its
lanes, then back.  Then, with the package's library, the build of each
deck with G = 1 and with the wide G forced, timed alike.  Prints one
line per variant, the lists' shapes and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import check_pairlist, cuda_ms, rhodo_setup  # noqa: E402
from tpumd_torch.bench_targets import IN_CHAIN, IN_CHUTE, IN_EAM, IN_LJ, \
    chain_data, chute_data, eam_funcfl  # noqa: E402
from tpumd_torch.ops import _build  # noqa: E402
from tpumd_torch.ops import cellgrid_gran as cgg  # noqa: E402
from tpumd_torch.ops import cellgrid_pairlist as bpl  # noqa: E402
from tpumd_torch.ops import eam_cellgrid as b4  # noqa: E402
from tpumd_torch.ops import gran_cellgrid as b6  # noqa: E402
from tpumd_torch.ops import lj_cellgrid as b1  # noqa: E402
from tpumd_torch.ops import lj_fene_cellgrid as b2  # noqa: E402
from tpumd_torch.script.parser import LammpsScript  # noqa: E402

TOL = 2e-6
OUT = ROOT / "build" / "pairlist_lanes"
# name: (source, lanes constant, lanes tried, the f32 entry and its
# argument types, the timed instance's mangled name with {t} for the
# lanes where its template takes them)
KERNELS = {
    "gran": ("gran_cellgrid.cu", "kLanes", (1, 2, 4, 8),
             b6._FN_NAMES[torch.float32], b6._ARGTYPES,
             r"gran_pairlist_kernelIfLb1ELb1ELb0E"),
    "fene": ("lj_fene_cellgrid.cu", "kLanes", (1, 2, 4, 8),
             b2._FN_NAMES[torch.float32], b2._ARGTYPES,
             r"lj_fene_pairlist_kernelILi{t}ELb1EfLb0ELb0E"),
    "lj": ("lj_fene_cellgrid.cu", "kLanesLJ", (4, 8, 16, 32),
           b1._FN_NAMES[torch.float32], b1._ARGTYPES,
           r"lj_fene_pairlist_kernelILi{t}ELb0EfLb0ELb0E"),
    "eam": ("eam_cellgrid.cu", "kLanesEAM", (4, 8, 16, 32),
            b4._FORCE_FN[torch.float32], b4._FORCE_ARGTYPES,
            r"eam_force_pairlist_kernelILi{t}ELb1EfLb0ELb0E"),
    "rho": ("eam_cellgrid.cu", "kLanesRho", (2, 4, 8, 16),
            b4._RHO_FN[torch.float32], b4._RHO_ARGTYPES,
            r"eam_rho_pairlist_kernelILi{t}ELb1EfLb0E"),
    "build": ("cellgrid_pairlist.cu", "kLanesBuild", (4, 8, 16, 32),
              "tpumd_cellgrid_pairlist_f32", bpl._ARGTYPES,
              r"cellgrid_pairlist_kernelIfLi{t}ELb1ELb0E"),
}


def _variants():
    """{kernel: [its f32 entry in one library per lanes tried]} and the
    ptxas log."""
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    srcs = []
    for name, (src_name, const, lanes, _, _, _) in KERNELS.items():
        src = (_build.CSRC / src_name).read_text()
        pattern = re.compile(rf"constexpr int {const} = \d+;")
        if len(pattern.findall(src)) != 1:
            raise RuntimeError(f"{src_name} must hold one {const} constant")
        for t in lanes:
            srcs.append(OUT / f"{name}_lanes{t}.cu")
            srcs[-1].write_text(pattern.sub(f"constexpr int {const} = {t};",
                                            src))
    objs, log = _build._compile_all(srcs, OUT)
    fns = {name: [] for name in KERNELS}
    for obj in objs:
        so = obj.with_suffix(".so")
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(so), str(obj)], check=True)
        name = obj.stem.split("_")[0]
        fn = getattr(ctypes.CDLL(str(so)), KERNELS[name][3])
        fn.argtypes, fn.restype = KERNELS[name][4], ctypes.c_int
        fns[name].append(fn)
    return fns, log


def _ptxas(log: str, name: str) -> str:
    """(registers, spill store bytes) of each lanes variant's timed
    instance, from the ptxas log."""
    _, _, lanes, _, _, mangled = KERNELS[name]
    out = []
    for k, t in enumerate(lanes):
        found = re.findall(mangled.format(t=t) + r".*?\n.*?(\d+) bytes spill "
                           r"stores.*?\n.*?Used (\d+) registers", log)
        sp, r = found[k if "{t}" not in mangled else 0] if found else ("?",
                                                                       "?")
        out.append(f"{t}: {r}, {sp}")
    return "; ".join(out)


def _err(out, ref):
    """The largest difference of each output relative to its largest
    value (energies relative to themselves)."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
               for a, b in zip(out, ref) if b is not None)


def _chute(tmp: Path):
    """(kernel arguments after fn, the plain list sweep's outputs) of the
    32k chute deck after 10 steps, f32, shearupdate."""
    chute_data(tmp / "data.chute")
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.run_string(IN_CHUTE.format(data=tmp / "data.chute"))
    script.sim.verbose = False
    script.run_string("run 10")
    sim = script.sim
    s, neigh, _ = sim._carry
    planes = (s.v, s.omega, s.radius,
              torch.where(s.rmass > 0, s.rmass, 1.0), s.gmask)
    c = sim.pair.kernel_coeffs()
    args = (s.x, s.tag, neigh.valid, neigh.shear_tags, neigh.shear, s.box,
            sim._neigh_cfg, c, planes, 1e-4, True,
            (neigh.pairs, neigh.npairs, neigh.row2slot))
    ref = cgg.gran_pairlist_plain(s.x, s.tag, neigh.shear_tags, neigh.shear,
                                  s.box, c, planes, 1e-4, True, neigh.pairs,
                                  neigh.npairs)
    return args, ref, sim


def _chain(tmp: Path):
    """(kernel arguments after fn, the plain list sweep's outputs with
    energy and virial) of the 32k chain deck after set-up, f32."""
    chain_data(tmp / "data.chain", 32000, 100)
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.run_string(IN_CHAIN.format(data=tmp / "data.chain"))
    script.sim.verbose = False
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    lj, fene = sim.pair.kernel_coeffs(), sim._ctx.kernel_bond.kernel_coeffs()
    plist = (neigh.pairs, neigh.npairs, neigh.bond_slots, neigh.row2slot)
    args = (s.x, neigh.valid, s.box, sim._neigh_cfg, lj, fene)
    ref = b2.lj_fene_pairlist_plain(s.x, s.box, lj, fene, True, True,
                                    *plist[:3])
    return args, plist, ref, sim


def _lj(tmp: Path):
    """(kernel arguments after fn, the plain list sweep's outputs with
    energy and virial) of the 32k in.lj deck after 10 steps (on the
    lattice of step 0 the forces cancel), f32."""
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.run_string(IN_LJ.format(n=20))
    script.sim.verbose = False
    script.run_string("run 10")
    sim = script.sim
    s, neigh, _ = sim._carry
    c = sim.pair.kernel_coeffs()
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    args = (s.x, neigh.valid, s.box, sim._neigh_cfg, c)
    ref = b1.lj_pairlist_plain(s.x, s.box, c, True, True, *plist[:2])
    return args, plist, ref, sim


def _eam(tmp: Path):
    """(kernel arguments after fn, the plain list sweep's outputs with
    energy and virial) of the 32k in.eam deck after 10 steps, f32, F' from
    the plain density pass."""
    eam_funcfl(tmp / "Cu.eam")
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.run_string(IN_EAM.format(n=20, potential=tmp / "Cu.eam"))
    script.sim.verbose = False
    script.run_string("run 10")
    sim = script.sim
    s, neigh, _ = sim._carry
    cfg = sim._neigh_cfg
    tab = sim.pair.kernel_tables(s.x)
    _, fp, _ = b4.eam_rho_cellgrid_plain(s.x, neigh.valid, s.box, cfg, tab,
                                         False)
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    args = (s.x, neigh.valid, fp, s.box, cfg, tab)
    ref = b4.eam_force_pairlist_plain(s.x, fp, s.box, tab, True, True,
                                      *plist[:2])
    return args, plist, ref, sim


def _rhodo():
    """The pair list build's arguments on the 32k rhodo_class grid after
    set-up, f32."""
    from tpumd_torch.core.state import Box
    script = rhodo_setup("2 2 4", "cuda", torch.float32)
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    return (s.x, neigh.valid, s.tag, s.special_tags, s.special_codes,
            Box(lo=s.box.lo, hi=s.box.hi), sim._neigh_cfg,
            sim._ctx.pairlist_k), sim


def _deck_bargs(sim):
    """The pair list build's arguments at a deck's state."""
    s, neigh, _ = sim._carry
    stags, scodes = s.special_tags, s.special_codes
    if sim._ctx.kernel_bond is not None:
        stags, scodes = s.bond_tags, torch.ones_like(s.bond_tags)
    return (s.x, neigh.valid, s.tag, stags, scodes, s.box, sim._neigh_cfg,
            sim._ctx.pairlist_k, s.gmask, sim._ctx.pairlist_exclude)


def _build_call(bargs):
    """A call of a build library's entry fn with G lanes on bargs, its hold
    and outputs made once: (pairs, npairs, stat) and the call."""
    x, valid, tag, stags, scodes, box, cfg, K = bargs[:8]
    gmask, excl = (bargs[8], bargs[9]) if len(bargs) > 8 else (None, ())
    hold = bpl.pairlist_hold(x, valid, tag, stags, scodes, cfg, gmask, excl,
                             keep=False)
    pairs = torch.empty((cfg.capacity, K), dtype=torch.int32,
                        device=x.device)
    npairs = torch.empty(cfg.capacity, dtype=torch.int32, device=x.device)
    stat = bpl.new_stat(x.device)

    def call(fn, lanes):
        rc = fn(*bpl._args(x, valid, box, cfg, pairs, npairs, stat, hold, 0,
                           0, lanes))
        if rc != 0:
            raise RuntimeError(f"build launch failed: CUDA error {rc}")
        return pairs, npairs, stat[0], stat[1] != 0
    return call


def main():
    if not torch.cuda.is_available():
        raise SystemExit("pairlist_lanes: torch.cuda.is_available() is "
                         "False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    fns, log = _variants()
    with tempfile.TemporaryDirectory() as tmpdir:
        gargs, gref, gsim = _chute(Path(tmpdir))
        fargs, fplist, fref, fsim = _chain(Path(tmpdir))
        largs, lplist, lref, lsim = _lj(Path(tmpdir))
        eargs, eplist, eref, esim = _eam(Path(tmpdir))
    rargs, rsim = _rhodo()
    rref = b4.eam_rho_pairlist_plain(eargs[0], eargs[1], eargs[3], eargs[5],
                                     True, *eplist[:2])
    bref = bpl.cellgrid_pairlist_plain(*rargs)
    build = _build_call(rargs)
    calls = {
        "gran": lambda fn, *flags: b6.launch(fn, *gargs),
        "fene": lambda fn, ef, vf: b2.launch(fn, *fargs, ef, vf, fplist),
        "lj": lambda fn, ef, vf: b1.launch(fn, *largs, ef, vf, lplist),
        "eam": lambda fn, ef, vf: b4.launch_force(fn, *eargs, ef, vf,
                                                  eplist),
        "rho": lambda fn, ef, vf: b4.launch_rho(
            fn, eargs[0], eargs[1], eargs[3], eargs[4], eargs[5], ef,
            eplist)}
    refs = {"fene": fref, "lj": lref, "eam": eref, "rho": rref}
    for name, (_, _, lanes, _, _, _) in KERNELS.items():
        for t, fn in zip(lanes, fns[name]):
            if name == "build":
                check_pairlist(f"build lanes {t}", build(fn, t), bref)
                continue
            out = calls[name](fn, True, True)
            torch.cuda.synchronize()
            if name == "gran":
                if not torch.equal(out[2], gref[2]):
                    raise AssertionError(f"gran lanes {t}: history tags "
                                         f"differ")
                err = _err(out[:2] + out[3:], gref[:2] + gref[3:])
            else:
                err = _err(out, refs[name])
            if err > TOL:
                raise AssertionError(f"{name} lanes {t}: {err} > {TOL}")
    for name, (_, _, lanes, _, _, _) in KERNELS.items():
        times = {t: [] for t in lanes}
        for order in (lanes, lanes[::-1]):
            for t in order:
                fn = fns[name][lanes.index(t)]
                if name == "build":
                    times[t].append(cuda_ms(lambda: build(fn, t), 50))
                    continue
                times[t].append(cuda_ms(lambda: calls[name](fn, False,
                                                            False), 200))
        for t in lanes:
            print(f"{name} lanes {t}: {min(times[t]):.4f} ms (rounds "
                  f"{', '.join(f'{v:.4f}' for v in times[t])}), f32 32k, "
                  f"within {TOL} of the plain list sweep", flush=True)
        best = min(lanes, key=lambda t: min(times[t]))
        print(f"{name} fastest: lanes {best}; ptxas (registers, spill "
              f"store bytes) by lanes: {_ptxas(log, name)}", flush=True)
    # the package's build on each deck, G = 1 against the wide G
    lib = _build.kernel_function("tpumd_cellgrid_pairlist_f32", bpl._ARGTYPES)
    for name, sim in (("chute", gsim), ("chain", fsim), ("in.lj", lsim),
                      ("eam", esim), ("rhodo_class", rsim)):
        bargs = _deck_bargs(sim)
        call = _build_call(bargs)
        ref = bpl.cellgrid_pairlist_plain(*bargs)
        times = {g: [] for g in bpl.LANES}
        for g in bpl.LANES:
            check_pairlist(f"{name} build G {g}", call(lib, g), ref)
        for order in (bpl.LANES, bpl.LANES[::-1]):
            for g in order:
                times[g].append(cuda_ms(lambda: call(lib, g), 50))
        print(f"{name} build: " + "; ".join(
            f"G {g} {min(v):.4f} ms (rounds "
            f"{', '.join(f'{t:.4f}' for t in v)})" for g, v in times.items())
            + f", f32 32k, the plain build's live entries", flush=True)
    for name, sim in (("chute", gsim), ("chain", fsim), ("in.lj", lsim),
                      ("eam", esim), ("rhodo_class", rsim)):
        neigh = sim._carry[1]
        live = neigh.npairs[neigh.valid].double()
        print(f"{name} list: K {sim._ctx.pairlist_k}, longest row "
              f"{int(neigh.max_pairs)}, {float(live.mean()):.3f} entries a "
              f"row", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
