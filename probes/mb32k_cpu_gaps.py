"""The f32 gaps of the 32k many-body decks on the CPU: the basis of the
card's f32 gates (``bench_targets.MB32K_F32_CPU_GAP`` and
``EAMALLOY_F32_CPU_GAP``).

Run from the repository root on any machine: ``python3
probes/mb32k_cpu_gaps.py [sw] [tersoff] [eam] [--cells N]`` (all three by
default; about 4 minutes on 4 CPU threads).  Each deck runs in f64 and in
f32 from the f64 deck's velocities and types through
``bench_targets.mb32k_f32_gaps``: the step-100 row's relative gaps and the
f32 forces on the f64 run's step-100 positions.  With --cells N the
many-body decks take N x N x N cells and the alloy N^3 replicas, for the
small decks' gaps (N = 3 and 1 are those of tests/test_torch_manybody.py
and tests/test_torch_eam_matrix.py).

f32's rounding of a position grows with the coordinate, so the forces'
gap at the 32k box (108.6 A) is several times the 3x3x3 deck's (16.3 A);
the intensive rows average more atoms and come out below it.  The gates
take, per column, the larger of the small deck's gap and the 32k deck's.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpumd_torch import bench_targets as bt  # noqa: E402
from tpumd_torch.script.parser import LammpsScript  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("decks", nargs="*", default=["sw", "tersoff", "eam"])
    ap.add_argument("--cells", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.decks:
            if name == "eam":
                pot = Path(tmp) / "CuAl.eam.alloy"
                bt.alloy_setfl(pot)
                deck = bt.IN_EAMALLOY.format(
                    n=args.cells or bt.EAMALLOY32K_REPS, potential=pot)
            else:
                pot = bt.write_potential(tmp, bt.MB32K_POTENTIAL[name])
                cells = (args.cells,) * 3 if args.cells else bt.MB32K_CELLS
                deck = bt.in_mb32k(name, pot, cells)

            def make(dtype):
                script = LammpsScript(device="cpu", dtype=dtype)
                script.run_string(deck)
                script.sim.verbose = False
                return script
            t0 = time.perf_counter()
            gaps = bt.mb32k_f32_gaps(make, steps=100)
            print(name, {k: float(f"{v:.3e}") for k, v in gaps.items()},
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
