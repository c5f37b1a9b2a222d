"""Command-line entry point:
``python -m tpumd_torch -in deck [-var name value]... [--dtype f32|f64]
[--device cuda|cpu]``.

Mirrors the reference's command line (src/main.cpp, src/lammps.cpp:189-680)
as tpumd/__main__.py does: -in/-i the deck, -var/-v an index variable's
value (repeatable; the deck's own ``variable ... index`` line does not
overwrite it), -log the log file, -echo screen|both to echo each command,
-sf (accepted and ignored: there are no suffix styles to switch),
-partition PxM with -plog NAME (the deck runs once per world, P in all, each
with its world variables' values, and writes its log to NAME.p; M, the
processors of a world, is accepted and ignored: the worlds run one after
another on the one device, which gives independent worlds the same
results, as tpumd/__main__.py:23-56 does).  Runs on the given device (CUDA
by default; asking for CUDA without a card raises).

Under ``torchrun --nproc_per_node P -m tpumd_torch -in deck`` (WORLD_SIZE
above 1 in the environment) the deck runs decomposed over P ranks, as
LAMMPS's ``mpirun -np P lmp -in deck`` does: NCCL with ``cuda:LOCAL_RANK``
each, or gloo with ``--device cpu``.  Every rank runs the whole script;
rank 0 prints the screen and writes the log and the files
(``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
    ap.add_argument("-partition", "-p", dest="partition", default=None,
                    metavar="PxM")
    ap.add_argument("-plog", dest="plog", default="log.lammps")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import torch
    from tpumd_torch.script.parser import LammpsScript
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return _main_ranks(args, dtype)
    if args.partition:
        nworld = int(str(args.partition).split("x")[0])
        for p in range(nworld):
            script = LammpsScript(device=args.device, dtype=dtype,
                                  var_overrides=dict(args.vars))
            script._world_index = p
            script.nworlds = nworld
            script.run_file(args.infile)
            if script.sim is not None:
                with open(f"{args.plog}.{p}", "w") as fh:
                    fh.write("\n".join(script.sim.log_lines) + "\n")
        return 0
    script = LammpsScript(device=args.device, dtype=dtype,
                          var_overrides=dict(args.vars))
    if args.echo:
        script.cmd_echo([args.echo])
    script.run_file(args.infile)
    if args.logfile and script.sim is not None:
        with open(args.logfile, "w") as fh:
            fh.write("\n".join(script.sim.log_lines) + "\n")
    return 0


def _main_ranks(args, dtype):
    """The deck on one rank of torchrun's process group."""
    import torch.distributed as dist
    from tpumd_torch.parallel.mesh import make_mesh
    from tpumd_torch.script.parser import LammpsScript
    if args.partition:
        raise NotImplementedError("-partition across ranks is not ported "
                                  "(ROADMAP item 14e)")
    mesh = make_mesh(device=args.device)
    try:
        with contextlib.ExitStack() as stack:
            if mesh.rank != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            script = LammpsScript(device=mesh.device, dtype=dtype,
                                  var_overrides=dict(args.vars), mesh=mesh)
            if args.echo:
                script.cmd_echo([args.echo])
            script.run_file(args.infile)
        if args.logfile and script.sim is not None and mesh.rank == 0:
            with open(args.logfile, "w") as fh:
                fh.write("\n".join(script.sim.log_lines) + "\n")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
