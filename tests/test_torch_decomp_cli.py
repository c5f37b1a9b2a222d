"""``torchrun -m tpumd_torch`` on the CPU: ``python -m
torch.distributed.run --standalone --nproc_per_node 2 -m tpumd_torch -in
deck --device cpu --dtype f64 -log log.lammps`` runs in.lj on 6^3 fcc
cells (a 3^3 cell grid split 1 + 2 into z-slabs) over two gloo ranks, and
rank 0 writes the log and the dump.  The log equals the one-rank run's
(``python -m tpumd_torch`` without WORLD_SIZE), the Loop time and
Performance lines excepted, and the dump file equals it byte for byte."""

import os
import subprocess
import sys
from pathlib import Path

from tpumd_torch.__main__ import main
from tpumd_torch.bench_targets import IN_LJ

ROOT = Path(__file__).resolve().parents[1]
DECK = (IN_LJ.format(n=6) + "thermo 10\ndump 1 all atom 10 dump.lj\n"
        "run 20\n")


def _rows(path):
    return [line for line in path.read_text().splitlines()
            if not line.startswith(("Loop time", "Performance"))]


def test_torchrun_writes_the_one_rank_log(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    for d in (one, two):
        d.mkdir()
        (d / "in.lj").write_text(DECK)
    cwd = os.getcwd()
    try:
        os.chdir(one)
        main(["-in", "in.lj", "--device", "cpu", "--dtype", "f64", "-log",
              "log.lammps"])
    finally:
        os.chdir(cwd)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "tpumd_torch", "-in", "in.lj",
         "--device", "cpu", "--dtype", "f64", "-log", "log.lammps"],
        cwd=two, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _rows(two / "log.lammps") == _rows(one / "log.lammps")
    loop = [line for line in (two / "log.lammps").read_text().splitlines()
            if line.startswith("Loop time")]
    assert loop and "on 2 devices" in loop[0]
    assert (two / "dump.lj").read_bytes() == (one / "dump.lj").read_bytes()
    # rank 0 alone printed the screen
    assert proc.stdout.count("Loop time of") == 1
