"""Command-line entry point:
``python -m tpumd_torch -in deck [-var name value]... [--dtype f32|f64]
[--device cuda|cpu]``.

Mirrors the reference's command line (src/main.cpp, src/lammps.cpp:189-680)
as tpumd/__main__.py does: -in/-i the deck, -var/-v an index variable's
value (repeatable; the deck's own ``variable ... index`` line does not
overwrite it), -log the log file, -echo screen|both to echo each command,
-sf (accepted and ignored: there are no suffix styles to switch).  Runs on
the given device (CUDA by default; asking for CUDA without a card raises).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpumd_torch")
    ap.add_argument("-in", "-i", dest="infile", required=True)
    ap.add_argument("-var", "-v", dest="vars", nargs=2, action="append",
                    default=[], metavar=("NAME", "VALUE"))
    ap.add_argument("-log", dest="logfile", default=None)
    ap.add_argument("-echo", dest="echo", default=None,
                    choices=["none", "screen", "log", "both"])
    ap.add_argument("-sf", dest="suffix", default=None)  # accepted, unused
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import torch
    from tpumd_torch.script.parser import LammpsScript
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    script = LammpsScript(device=args.device, dtype=dtype,
                          var_overrides=dict(args.vars))
    if args.echo:
        script.cmd_echo([args.echo])
    script.run_file(args.infile)
    if args.logfile and script.sim is not None:
        with open(args.logfile, "w") as fh:
            fh.write("\n".join(script.sim.log_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
