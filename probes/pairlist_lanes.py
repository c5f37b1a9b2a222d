"""Lanes per atom of the pair list sweeps on the card: gran/hooke/history
(B6), LJ+FENE (B2), lj/cut (B1) and the EAM force pass (B4).

Run from the repository root: ``python3 probes/pairlist_lanes.py``.
Builds a copy of each kernel's source for each lanes per atom it is
tried at (B6 and B2: 1, 2, 4 and 8; B1 and B4: 4, 8, 16 and 32), its
lanes constant (``kLanes`` of ``tpumd_torch/csrc/gran_cellgrid.cu`` and
``lj_fene_cellgrid.cu``, ``kLanesLJ`` of the latter, ``kLanesEAM`` of
``eam_cellgrid.cu``) rewritten in the copy (the package keeps one
value), all with one nvcc each at once, into ``build/pairlist_lanes/``.
Sets up the 32,000-sphere chute deck (f32, 10 steps, so the contact
history is live), the 32,000-atom chain deck (f32, set-up) and the in.lj
and in.eam decks (f32, 10 steps: on their lattices the forces cancel),
each with its pair list built by the list kernel; holds
each variant's outputs against the plain list sweep (forces, torques and
virial to 2e-6 of their largest, energies to 2e-6 relative, history tags
equal) and times the launch the main path makes most (B6 with
shearupdate, the others forces only) with ``chip_smoke.cuda_ms`` (CUDA
events around 200 launches queued behind a spin kernel, so that the card
runs them back to back), in the order of its lanes, then back.  Prints
one line per variant, the lists' shapes and the card's name and power
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

from chip_smoke import cuda_ms  # noqa: E402
from tpumd_torch.bench_targets import IN_CHAIN, IN_CHUTE, IN_EAM, IN_LJ, \
    chain_data, chute_data, eam_funcfl  # noqa: E402
from tpumd_torch.ops import _build  # noqa: E402
from tpumd_torch.ops import cellgrid_gran as cgg  # noqa: E402
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
    calls = {
        "gran": lambda fn, *flags: b6.launch(fn, *gargs),
        "fene": lambda fn, ef, vf: b2.launch(fn, *fargs, ef, vf, fplist),
        "lj": lambda fn, ef, vf: b1.launch(fn, *largs, ef, vf, lplist),
        "eam": lambda fn, ef, vf: b4.launch_force(fn, *eargs, ef, vf,
                                                  eplist)}
    refs = {"fene": fref, "lj": lref, "eam": eref}
    for name, (_, _, lanes, _, _, _) in KERNELS.items():
        for t, fn in zip(lanes, fns[name]):
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
                times[t].append(cuda_ms(lambda: calls[name](fn, False,
                                                            False), 200))
        for t in lanes:
            print(f"{name} lanes {t}: {min(times[t]):.4f} ms (rounds "
                  f"{', '.join(f'{v:.4f}' for v in times[t])}), f32 32k, "
                  f"within {TOL} of the plain list sweep", flush=True)
        best = min(lanes, key=lambda t: min(times[t]))
        print(f"{name} fastest: lanes {best}; ptxas (registers, spill "
              f"store bytes) by lanes: {_ptxas(log, name)}", flush=True)
    for name, sim in (("chute", gsim), ("chain", fsim), ("in.lj", lsim),
                      ("eam", esim)):
        neigh = sim._carry[1]
        live = neigh.npairs[neigh.valid].double()
        print(f"{name} list: K {sim._ctx.pairlist_k}, longest row "
              f"{int(neigh.max_pairs)}, {float(live.mean()):.3f} entries a "
              f"row", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
