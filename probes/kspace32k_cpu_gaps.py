"""The CPU numbers behind the card's gates of IN_TIP4P30K and IN_DPD32K
(``bench_targets.TIP4P30K_*`` and ``DPD32K_*``).

Run from the repository root on any machine: ``python3
probes/kspace32k_cpu_gaps.py [tip4p] [dpd]`` (both by default; about 5
minutes on 4 CPU threads, under 2 GB).  For each deck, in float64 on the
CPU:

* the full deck's step-0 row (the card's f64 step-0 targets);
* the f32 gaps (``bench_targets.f32_gaps_at``: f32 on the f64 state's
  positions and velocities, each column's relative gap and the forces'
  gap of max|f|) of the cell (tests/golden/tip4p's 375 atoms; 4^3 cells of
  the DPD lattice) at its step 100 and of the full deck at step 0;
* for DPD, the mean temperature of the rows of steps 100-1000 of the
  10^3-cell deck (4,000 particles).

The card's gates take, per column, 3x the larger of the cell's gap and the
full deck's.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpumd_torch import bench_targets as bt  # noqa: E402
from tpumd_torch.script.parser import LammpsScript  # noqa: E402

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden" / "tip4p"


def decks(name, thermo):
    if name == "tip4p":
        full = bt.IN_TIP4P30K.format(golden=GOLDEN, thermo=thermo)
        cell = full.replace("replicate       4 4 5\n", "")
    else:
        full = bt.IN_DPD32K.format(n=bt.DPD32K_CELLS, thermo=thermo)
        cell = bt.IN_DPD32K.format(n=4, thermo=thermo)
    return full, cell


def f64_script(deck):
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(deck)
    script.sim.verbose = False
    script.run_string("run 0")
    return script


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("decks", nargs="*", default=["tip4p", "dpd"])
    args = ap.parse_args()
    torch.set_num_threads(4)
    for name in args.decks:
        t0 = time.perf_counter()
        full, cell = decks(name, 100)
        ref = f64_script(full)
        row = {k: ref.sim.last_thermo[k] for k in
               ("temp", "epair", "evdwl", "ecoul", "elong", "emol",
                "etotal", "press")}
        print(f"{name} full step 0 f64: {row!r}", flush=True)
        gaps_full, _ = bt.f32_gaps_at(ref, full, "cpu")
        print(f"{name} full step-0 f32 gaps: {gaps_full!r}", flush=True)
        del ref
        c = f64_script(cell)
        c.run_string("run 100")
        gaps_cell, _ = bt.f32_gaps_at(c, cell, "cpu")
        print(f"{name} cell step-100 f32 gaps: {gaps_cell!r}", flush=True)
        basis = {k: max(gaps_full[k], gaps_cell[k]) for k in gaps_full}
        print(f"{name} basis: {basis!r}", flush=True)
        if name == "dpd":
            small = f64_script(bt.IN_DPD32K.format(n=10, thermo=100))
            small.run_string("run 1000")
            temps = [float(ln.split()[1]) for ln in small.sim.log_lines
                     if ln.split() and ln.split()[0].isdigit()
                     and int(ln.split()[0]) >= 100]
            print(f"dpd 10^3 f64 mean temperature, steps 100-1000: "
                  f"{np.mean(temps)!r} over {len(temps)} rows", flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
