"""What the pair list's refresh costs a host-bound step, on the card.

Run from the repository root: ``python3 probes/refresh_cost.py``.  Sets up
the 32k in.lj deck (f32; it re-bins every 20 steps unchecked, so every
step without a re-bin calls the refresh) and runs 200 steps;
``chip_smoke.time_upkeep`` checks the refresh on that state (a clear gate
leaves the list untouched, a rebuilding refresh equals the plain build)
and times it.  Then times 500 steps (host clock to a synchronize) in
turns, three rounds: with the refresh ("refresh"), with it left out
("none": the list then goes stale, so these runs measure time only), and
with it replaced by a second launch of B1 ("B1 again": an ordinary launch
through a wrapper of like host cost).  Prints timesteps/s and the card's
name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import time_upkeep  # noqa: E402
from tpumd_torch.bench_targets import IN_LJ  # noqa: E402
from tpumd_torch.md import verlet  # noqa: E402
from tpumd_torch.ops import lj_cellgrid as b1  # noqa: E402
from tpumd_torch.script.parser import LammpsScript  # noqa: E402

def main():
    if not torch.cuda.is_available():
        raise SystemExit("refresh_cost: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.run_string(IN_LJ.format(n=20))
    sim = script.sim
    sim.verbose = False
    script.run_string("run 200")
    time_upkeep("in.lj", sim, build=False)
    real = verlet.refresh_list

    def b1_again(s, neigh, ctx):
        b1.lj_cellgrid(s.x, neigh.valid, s.box, ctx.neigh_cfg,
                       ctx.pair.kernel_coeffs(), False, False,
                       (neigh.pairs, neigh.npairs, neigh.row2slot))
        return neigh

    variants = {"refresh": real, "none": lambda s, neigh, ctx: neigh,
                "B1 again": b1_again}
    sps = {k: [] for k in variants}
    for _ in range(3):
        for name, fn in variants.items():
            verlet.refresh_list = fn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            script.run_string("run 500")
            torch.cuda.synchronize()
            sps[name].append(500 / (time.perf_counter() - t0))
    verlet.refresh_list = real
    for name, v in sps.items():
        print(f"in.lj 32k f32, 500 steps, {name}: "
              + ", ".join(f"{x:.2f}" for x in v) + " timesteps/s",
              flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
