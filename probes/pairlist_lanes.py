"""Lanes per atom of the gran/hooke/history (B6) and LJ+FENE (B2) list
kernels, on the card.

Run from the repository root: ``python3 probes/pairlist_lanes.py``.
Builds a copy of ``tpumd_torch/csrc/gran_cellgrid.cu`` and of
``tpumd_torch/csrc/lj_fene_cellgrid.cu`` for each of 1, 2, 4 and 8 lanes
per atom (their ``constexpr int kLanes``, rewritten in the copies; the
package keeps one value), all with one nvcc each at once, into
``build/pairlist_lanes/``.  Sets up the 32,000-sphere chute deck (f32, 10
steps, so the contact history is live) and the 32,000-atom chain deck
(f32, set-up), each with its pair list built by the list kernel; holds
each variant's outputs against the plain list sweep (forces, torques and
virial to 2e-6 of their largest, energies to 2e-6 relative, history tags
equal) and times its launch the main path makes most (B6 with
shearupdate, B2 forces only) with ``chip_smoke.cuda_ms`` (CUDA events
around 200 launches queued behind a spin kernel, so that the card runs
them back to back), in the order 1, 2, 4, 8, then back.  Prints one line
per variant and the card's name and power limit.
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
from tpumd_torch.bench_targets import IN_CHAIN, IN_CHUTE, chain_data, \
    chute_data  # noqa: E402
from tpumd_torch.ops import _build  # noqa: E402
from tpumd_torch.ops import cellgrid_gran as cgg  # noqa: E402
from tpumd_torch.ops import gran_cellgrid as b6  # noqa: E402
from tpumd_torch.ops import lj_fene_cellgrid as b2  # noqa: E402
from tpumd_torch.script.parser import LammpsScript  # noqa: E402

LANES = (1, 2, 4, 8)
TOL = 2e-6
CONSTANT = re.compile(r"constexpr int kLanes = \d+;")
OUT = ROOT / "build" / "pairlist_lanes"
# source, wrapper module, the timed instance's mangled name
KERNELS = {"gran": ("gran_cellgrid.cu", b6,
                    r"gran_pairlist_kernelIfLb1ELb1ELb0E"),
           "fene": ("lj_fene_cellgrid.cu", b2,
                    r"lj_fene_pairlist_kernelIfLb0ELb0E")}


def _variants():
    """{kernel: [one loaded library per entry of LANES]} and the ptxas
    log."""
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    srcs = []
    for name, (src_name, _, _) in KERNELS.items():
        src = (_build.CSRC / src_name).read_text()
        if len(CONSTANT.findall(src)) != 1:
            raise RuntimeError(f"{src_name} must hold one kLanes constant")
        for t in LANES:
            srcs.append(OUT / f"{name}_lanes{t}.cu")
            srcs[-1].write_text(CONSTANT.sub(f"constexpr int kLanes = {t};",
                                             src))
    objs, log = _build._compile_all(srcs, OUT)
    libs = {name: [] for name in KERNELS}
    for obj in objs:
        so = obj.with_suffix(".so")
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(so), str(obj)], check=True)
        libs[obj.stem.split("_")[0]].append(ctypes.CDLL(str(so)))
    return libs, log


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("pairlist_lanes: torch.cuda.is_available() is "
                         "False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    libs, log = _variants()
    fns = {}
    for name, (_, mod, _) in KERNELS.items():
        fns[name] = []
        for lib in libs[name]:
            fn = getattr(lib, mod._FN_NAMES[torch.float32])
            fn.argtypes, fn.restype = mod._ARGTYPES, ctypes.c_int
            fns[name].append(fn)
    with tempfile.TemporaryDirectory() as tmpdir:
        gargs, gref, gsim = _chute(Path(tmpdir))
        fargs, plist, fref, fsim = _chain(Path(tmpdir))
    calls = {
        "gran": lambda fn: b6.launch(fn, *gargs),
        "fene": lambda fn: b2.launch(fn, *fargs, False, False, plist)}
    for t, fn in zip(LANES, fns["gran"]):
        out = b6.launch(fn, *gargs)
        torch.cuda.synchronize()
        if not torch.equal(out[2], gref[2]):
            raise AssertionError(f"gran lanes {t}: history tags differ")
        err = _err(out[:2] + out[3:], gref[:2] + gref[3:])
        if err > TOL:
            raise AssertionError(f"gran lanes {t}: {err} > {TOL}")
    for t, fn in zip(LANES, fns["fene"]):
        out = b2.launch(fn, *fargs, True, True, plist)
        torch.cuda.synchronize()
        err = _err(out, fref)
        if err > TOL:
            raise AssertionError(f"fene lanes {t}: {err} > {TOL}")
    for name in KERNELS:
        times = {t: [] for t in LANES}
        for order in (LANES, LANES[::-1]):
            for t in order:
                fn = fns[name][LANES.index(t)]
                times[t].append(cuda_ms(lambda: calls[name](fn), 200))
        regs = re.findall(KERNELS[name][2] + r".*?\n.*?(\d+) bytes spill "
                          r"stores.*?\n.*?Used (\d+) registers", log)
        for t in LANES:
            print(f"{name} lanes {t}: {min(times[t]):.4f} ms (rounds "
                  f"{', '.join(f'{v:.4f}' for v in times[t])}), f32 32k, "
                  f"within {TOL} of the plain list sweep", flush=True)
        best = min(LANES, key=lambda t: min(times[t]))
        print(f"{name} fastest: lanes {best}; ptxas (registers, spill "
              f"store bytes) by lanes: " + "; ".join(
                  f"{t}: {r}, {sp}" for t, (sp, r) in zip(LANES, regs)),
              flush=True)
    for name, sim in (("chute", gsim), ("chain", fsim)):
        neigh = sim._carry[1]
        live = neigh.npairs[neigh.valid].double()
        print(f"{name} list: K {sim._ctx.pairlist_k}, longest row "
              f"{int(neigh.max_pairs)}, {float(live.mean()):.3f} entries a "
              f"row", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
