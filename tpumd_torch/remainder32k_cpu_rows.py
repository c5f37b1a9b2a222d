"""The CPU numbers behind the card's gates of IN_KAPPA32K, IN_BONDCREATE32K
and IN_CHAIN_RESPA32K (``bench_targets.KAPPA32K_*``, ``BONDCREATE32K_*``
and ``CHAIN_RESPA32K_*``).

Run from the repository root on any machine: ``python3 -m
tpumd_torch.remainder32k_cpu_rows [kappa] [bondcreate] [respa]`` (all by
default; about 90 s on 4 CPU threads, under 3 GB).  In float64 on
the CPU, through the port:

* IN_KAPPA32K: the rows of steps 0 and 100 at full precision (f_2
  included) and the largest |etotal - etotal(0)| / |etotal(0)| over steps
  0-100 a step apart (runs of one step: the trajectory is the one run's);
* IN_BONDCREATE32K: the step-0 row and the bonds made at step 5, their
  count and the sha256 of their sorted tag pairs;
* IN_CHAIN_RESPA32K on chain_data(): the step-0 row.
"""

import argparse
import hashlib
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpumd_torch import bench_targets as bt
from tpumd_torch.script.parser import LammpsScript


def script_of(deck):
    s = LammpsScript(device="cpu", dtype=torch.float64)
    s.run_string(deck)
    s.sim.verbose = False
    return s


def pairs_digest(bonds) -> tuple[int, str]:
    """(count, sha256 of the sorted 'a b' lines) of bonds' tag pairs."""
    pairs = sorted(tuple(sorted((int(b[1]), int(b[2])))) for b in bonds)
    text = "\n".join(f"{a} {b}" for a, b in pairs)
    return len(pairs), hashlib.sha256(text.encode()).hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("decks", nargs="*",
                    default=["kappa", "bondcreate", "respa"])
    args = ap.parse_args()
    torch.set_num_threads(4)
    tmp = Path(tempfile.mkdtemp())
    if "kappa" in args.decks:
        t0 = time.perf_counter()
        s = script_of(bt.IN_KAPPA32K.format(n=20, grid=tmp / "grid",
                                            thermo=100))
        s.run_string("run 0")
        rows = {0: dict(s.sim.last_thermo)}
        for _ in range(100):
            s.run_string("run 1")
            rows[s.sim.step] = dict(s.sim.last_thermo)
        keys = ("temp", "epair", "etotal", "f_2")
        e = np.array([rows[k]["etotal"] for k in sorted(rows)])
        print("KAPPA32K_ROWS_F64 =", {k: {c: rows[k][c] for c in keys}
                                     for k in (0, 100)})
        print("KAPPA32K_ETOTAL_DRIFT_F64 =",
              float(np.abs(e - e[0]).max() / abs(e[0])))
        print(f"# {time.perf_counter() - t0:.1f} s")
    if "bondcreate" in args.decks:
        t0 = time.perf_counter()
        s = script_of(bt.IN_BONDCREATE32K.format(n=20, local=tmp / "local",
                                                 thermo=5))
        s.run_string("run 0")
        print("BONDCREATE32K_STEP0_F64 =", {
            c: s.sim.last_thermo[c]
            for c in ("temp", "ebond", "epair", "etotal", "press")})
        s.run_string("run 5")
        print("BONDCREATE32K_STEP5_BONDS =",
              pairs_digest(s.sim.live_topology("bond")))
        print(f"# {time.perf_counter() - t0:.1f} s")
    if "respa" in args.decks:
        t0 = time.perf_counter()
        data = tmp / "data.chain"
        bt.chain_data(str(data))
        s = script_of(bt.IN_CHAIN_RESPA32K.format(data=data, inner=2,
                                                  thermo=100))
        s.run_string("run 0")
        print("CHAIN_RESPA32K_STEP0_F64 =", {
            c: s.sim.last_thermo[c]
            for c in ("temp", "epair", "emol", "etotal", "press")})
        print(f"# {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
