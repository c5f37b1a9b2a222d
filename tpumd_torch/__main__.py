"""Command-line entry point:
``python -m tpumd_torch -in deck [--dtype f32|f64] [--device cuda|cpu]``.

Runs the deck on the given device (CUDA by default; asking for CUDA
without a card raises) and optionally writes the log (-log file).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpumd_torch")
    ap.add_argument("-in", "-i", dest="infile", required=True)
    ap.add_argument("-log", dest="logfile", default=None)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import torch
    from tpumd_torch.script.parser import LammpsScript
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    script = LammpsScript(device=args.device, dtype=dtype)
    script.run_file(args.infile)
    if args.logfile and script.sim is not None:
        with open(args.logfile, "w") as fh:
            fh.write("\n".join(script.sim.log_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
