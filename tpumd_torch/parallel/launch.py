"""A world of worker processes over ``torch.distributed``, and the worker
that runs a deck decomposed over it.

``spawn_world(fn, nprocs, backend, init_file)`` starts nprocs processes
(``spawn``), each of which joins a process group (gloo on the CPU, one
thread a worker; NCCL with ``cuda:rank``) through the file init_file,
calls ``fn(mesh, *args)`` and hands its result back; a worker that raises,
or a world that outlives its timeout, fails the call and stops every
worker.  The tests and the chip check spawn through it: a worker imports
only ``tpumd_torch`` (a worker defined in a test module would import that
module's imports, and with them jax).  ``run_deck`` is the worker they
spawn.
"""

from __future__ import annotations

import contextlib
import os
import queue
import time
import traceback

import torch


def _worker(rank, nprocs, backend, init_file, fn, args, results):
    import torch.distributed as dist
    from tpumd_torch.parallel.mesh import Mesh
    try:
        if backend == "nccl":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=nprocs)
        mesh = Mesh(rank=rank, size=nprocs, device=device, distributed=True)
        with contextlib.ExitStack() as stack:
            if rank != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, which fails the world
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, nprocs: int, backend: str, init_file, args=(),
                timeout: float = 300.0) -> list:
    """[fn(mesh, *args) of each rank], in rank order, from nprocs spawned
    workers in one process group (backend "gloo" or "nccl", rendezvous
    through the file init_file, which must not exist yet).  Raises the
    first failed worker's traceback, or TimeoutError after timeout
    seconds; every worker is stopped either way."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(
        r, nprocs, backend, str(init_file), fn, tuple(args), results))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} of {nprocs} exited (code "
                        f"{procs[dead[0]].exitcode}) with no result") \
                        from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {nprocs} ({backend}) still ran after "
                        f"{timeout:.0f} s; ranks {sorted(got)} had "
                        "finished") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(got) == nprocs else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
    return [got[r] for r in range(nprocs)]


def tag_order(s, *names):
    """The fields names of state s in tag order, numpy float64 (padding
    dropped)."""
    idx = torch.nonzero(s.tag > 0).reshape(-1)
    idx = idx[torch.argsort(s.tag[idx])]
    return [getattr(s, k)[idx].detach().cpu().double().numpy()
            for k in names]


def run_deck(mesh, spec: dict) -> dict:
    """Run a deck on this rank: spec holds "setup" (the deck up to its
    first run), "mode" (neighbor_mode), "dtype" ("f64" or "f32"), "runs"
    (the rest of the deck, each piece a str), and optionally "vars" (the
    command line's -var values), "timed" (a count of steps run afterwards
    as ``run N``, timed on the host's clock with the exchanges' CUDA
    events on), "steady" (a count of steps run last through
    ``run_segment`` with the collectives counted alone: the steps between
    output steps, with no re-bin where the schedule holds none) and
    "refusal" (the deck is expected to raise NotImplementedError: its
    message is returned).  Returns the thermo rows, the log, x and v in
    tag order, the launch counts of B1, B3/B4, the list build and
    refresh and P1 (those of the timed window apart), and the
    collectives' counts; "bonded_grid" sets the attribute on one card.
    B5's counts ("b5") are (its launches, of which B5-rows, plain
    calls)."""
    from tpumd_torch.md.verlet import run_segment
    from tpumd_torch.ops import cellgrid_pairlist, charmm_cellgrid, \
        eam_cellgrid, gather, lj_cellgrid
    from tpumd_torch.script.parser import LammpsScript
    counters = {"b1": lj_cellgrid.counts, "rho": eam_cellgrid.rho_counts,
                "force": eam_cellgrid.force_counts,
                "b5": charmm_cellgrid.counts,
                "build": cellgrid_pairlist.counts,
                "refresh": cellgrid_pairlist.refresh_counts,
                "p1": gather.counts}

    def launches(c):
        if c is charmm_cellgrid.counts:
            return c.kernel_launches, c.rows_launches, c.plain_calls
        return c.kernel_launches, c.plain_calls
    for c in counters.values():
        c.reset()
    mesh.counters.reset()
    dtype = torch.float64 if spec.get("dtype", "f64") == "f64" \
        else torch.float32
    script = LammpsScript(device=mesh.device, dtype=dtype, mesh=mesh,
                          var_overrides=spec.get("vars"))
    script.data_dir = spec.get("data_dir", ".")
    try:
        script.run_string(spec["setup"])
        sim = script.sim
        sim.verbose = False
        sim.neighbor_mode = spec.get("mode", "auto")
        if "bonded_grid" in spec:
            sim.bonded_grid = spec["bonded_grid"]
        for piece in spec.get("runs", ()):
            script.run_string(piece)
    except NotImplementedError as e:
        if "refusal" not in spec:
            raise
        return {"refused": str(e)}
    if "refusal" in spec:
        raise AssertionError(f"the deck ran; expected a refusal naming "
                             f"{spec['refusal']!r}")
    x, v = tag_order(sim.state, "x", "v")
    out = {"rows": list(sim.thermo_rows), "log": list(sim.log_lines), "x": x,
           "v": v, "natoms": sim.natoms,
           "counts": {k: launches(c) for k, c in counters.items()},
           "collectives": mesh.counters.snapshot(),
           "nbuilds": sim._carry[1].nbuilds}
    ctx = sim._ctx
    if ctx.decomp is not None and ctx.decomp.kind == "grid":
        lay = ctx.decomp.layout
        out["layout"] = {"pz": lay.pz, "py": lay.py,
                         "local": (lay.local_cfg.nz, lay.local_cfg.ny,
                                   lay.local_cfg.nx, lay.local_cfg.cap)}
    if spec.get("timed"):
        for c in counters.values():
            c.reset()
        mesh.counters.reset()
        mesh.timed = True
        t0 = sim.loop_time
        script.run_string(f"run {spec['timed']}")
        mesh.timed = False
        out["timed"] = {"steps": spec["timed"],
                        "seconds": sim.loop_time - t0,
                        "exchange_ms": mesh.counters.exchange_ms(),
                        "collectives": mesh.counters.snapshot(),
                        "counts": {k: launches(c)
                                   for k, c in counters.items()},
                        "row": dict(sim.last_thermo)}
    if spec.get("steady"):
        mesh.counters.reset()
        run_segment(*sim._carry, ctx, spec["steady"], step0=sim.step)
        out["steady"] = mesh.counters.snapshot()
    out["itemsize"] = torch.empty((), dtype=dtype).element_size()
    return out


def run_decks(mesh, specs) -> list:
    """``run_deck`` of each spec in turn, in one world."""
    return [run_deck(mesh, spec) for spec in specs]
