"""Lanes per atom of the lj/charmm/coul/long list kernel (B5), on the card.

Run from the repository root: ``python3 probes/charmm_lanes.py``.  Builds a
copy of ``tpumd_torch/csrc/charmm_cellgrid.cu`` for each of 4, 8, 16 and 32
lanes per slot (its ``constexpr int kLanes``, rewritten in the copy; the
package keeps one value), all with one nvcc each at once, into
``build/charmm_lanes/``.  Sets up the 32,064-atom rhodo_class deck (f64
set-up, its pair list built by the list kernel), holds each variant's
forces, energies and virial on the f32 state against the plain list sweep
(the f32 tolerance of chip_smoke.py), and times its forces-only launch with
CUDA events, 50 launches a round, in the order 4, 8, 16, 32, then back.
Prints one line per variant and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpumd_torch.bench_targets import IN_RHODO_CLASS  # noqa: E402
from tpumd_torch.core.state import Box  # noqa: E402
from tpumd_torch.ops import _build  # noqa: E402
from tpumd_torch.ops import charmm_cellgrid as b5  # noqa: E402
from tpumd_torch.script.parser import LammpsScript  # noqa: E402

LANES = (4, 8, 16, 32)
TOL = 5e-5
CONSTANT = "constexpr int kLanes = 32;"
OUT = ROOT / "build" / "charmm_lanes"


def _variants():
    """One loaded library per entry of LANES, and the ptxas log."""
    src = (_build.CSRC / "charmm_cellgrid.cu").read_text()
    if src.count(CONSTANT) != 1:
        raise RuntimeError(f"charmm_cellgrid.cu must hold {CONSTANT!r} once")
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    srcs = []
    for t in LANES:
        srcs.append(OUT / f"charmm_lanes{t}.cu")
        srcs[-1].write_text(src.replace(CONSTANT,
                                        f"constexpr int kLanes = {t};"))
    objs, log = _build._compile_all(srcs, OUT)
    libs = []
    for obj in objs:
        so = obj.with_suffix(".so")
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(so), str(obj)], check=True)
        libs.append(ctypes.CDLL(str(so)))
    return libs, log


def _ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("charmm_lanes: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    libs, log = _variants()
    fns = []
    for lib in libs:
        fn = getattr(lib, b5._FN_NAMES[torch.float32])
        fn.argtypes, fn.restype = b5._ARGTYPES, ctypes.c_int
        fns.append(fn)
    golden = ROOT / "tests" / "golden" / "peptide"
    script = LammpsScript(device="cuda", dtype=torch.float64)
    script.run_string(IN_RHODO_CLASS.format(golden=golden))
    sim = script.sim
    sim.verbose = False
    script.run_string("run 0")
    s, neigh, _ = sim._carry
    x = s.x.float()
    box = Box(lo=s.box.lo.float(), hi=s.box.hi.float())
    c = sim.pair.kernel_coeffs(x, *sim._special_weights())
    args = (x, s.q.float(), s.type, neigh.pairs, neigh.npairs, box,
            sim._neigh_cfg, c)
    plain = b5.charmm_pairlist_plain(*args[:5], box, c, True, True)
    fmax = float(plain[0].abs().max())
    for t, fn in zip(LANES, fns):
        out = b5.launch(fn, *args, True, True)
        torch.cuda.synchronize()
        err = float((out[0] - plain[0]).abs().max()) / fmax
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in zip(out[1:], plain[1:])]
        if err > TOL or max(rel) > TOL:
            raise AssertionError(f"lanes {t}: forces {err}, energies and "
                                 f"virial {rel} > {TOL}")
    times = {t: [] for t in LANES}
    for order in (LANES, LANES[::-1]):
        for t in order:
            fn = fns[LANES.index(t)]
            times[t].append(_ms(lambda: b5.launch(fn, *args, False, False)))
    # the forces-only f32 instance of each variant, in build order
    regs = re.findall(r"charmm_pairlist_kernelIfLb0ELb0E.*?\n.*?(\d+) "
                      r"bytes spill stores.*?\n.*?Used (\d+) registers", log)
    for t in LANES:
        print(f"lanes {t}: forces only {min(times[t]):.4f} ms (rounds "
              f"{', '.join(f'{v:.4f}' for v in times[t])}), f32 32k "
              f"rhodo_class, within {TOL} of the plain list sweep",
              flush=True)
    best = min(LANES, key=lambda t: min(times[t]))
    print(f"fastest: lanes {best}; K {sim._ctx.pairlist_k}, longest row "
          f"{int(neigh.max_pairs)}, {int(neigh.npairs.sum())} entries; "
          f"ptxas (registers, spill store bytes) by lanes: " + "; ".join(
              f"{t}: {r}, {sp}" for t, (sp, r) in zip(LANES, regs)),
          flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
