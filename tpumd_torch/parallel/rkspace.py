"""r/k-space split: the real-space and k-space forces evaluated at once.

The port of tpumd/parallel/rkspace.py, the analog of the reference's
verlet/split run style (src/REPLICA/verlet_split.cpp), where one MPI
partition computes the pair and bonded forces while another computes
PPPM.  tpumd puts the two on two devices of a mesh; on one card the port
puts them on two CUDA streams: k-space on a side stream, the r-space
categories (pair, bond, angle, dihedral, improper) through
``compute_forces(..., cats=...)`` on the current one.  The side stream
waits on the current stream before it starts (the inputs are written
there), and the current stream waits on the side stream before the sum
f_r + f_k.  Wall clock is then max(r-space, k-space) where the card has
room for both, instead of their sum.

The k-space branch reads the positions, charges, types and box, never the
pair list.  Its output is allocated on the side stream and marked for the
current one (``record_stream``); the solver's cached tables are made at
the run's set-up, on the current stream.  A host read inside the solver
(a ``.item()``, a Python branch on a tensor) would make the host wait for
the side stream and serialise the two.

On CPU tensors the two parts run one after the other: that is the plain
version.  On CUDA tensors there is no path that runs them on one stream.
tpumd exposes the split only as these functions, and so does the port (no
``run_style verlet/split``).
"""

from __future__ import annotations

import torch

from tpumd_torch.md.verlet import compute_forces

RCATS = ("pair", "bond", "angle", "dihedral", "improper")

# one side stream a card, made at its first split
_side_streams: dict = {}


def side_stream(device) -> torch.cuda.Stream:
    """The k-space stream of a CUDA device."""
    key = torch.device(device).index or 0
    if key not in _side_streams:
        _side_streams[key] = torch.cuda.Stream(device=device)
    return _side_streams[key]


def kspace_forces(s, ctx):
    """The k-space forces on the rows of s (zero without a solver); a
    TIP4P style's charge sites stand in for its atoms, their forces spread
    back onto the atoms (as ``compute_forces`` does)."""
    if ctx.kspace is None:
        return torch.zeros_like(s.x)
    pair = ctx.pair
    if getattr(pair, "is_tip4p", False):
        sites = pair.charge_sites(s, ctx.natoms)
        fk = ctx.kspace.compute(sites.xq, s.q, s.box, False, False,
                                type_=s.type)[0]
        return sites.distribute(fk)
    return ctx.kspace.compute(s.x, s.q, s.box, False, False,
                              type_=s.type)[0]


def make_split_force_fn(ctx):
    """fn(s, neigh) -> f: the r-space categories on the current stream
    and k-space on a side stream (on the CPU, one after the other), summed
    f_r + f_k, the order in which ``compute_forces`` adds k-space last."""

    def fn(s, neigh):
        if s.x.device.type == "cpu":
            f_r = compute_forces(s, neigh, ctx, False, False, cats=RCATS)[0]
            return f_r + kspace_forces(s, ctx)
        if s.x.device.type != "cuda":
            raise ValueError(f"r/k split: no streams on {s.x.device}")
        cur = torch.cuda.current_stream(s.x.device)
        side = side_stream(s.x.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            f_k = kspace_forces(s, ctx)
        f_r = compute_forces(s, neigh, ctx, False, False, cats=RCATS)[0]
        cur.wait_stream(side)
        f_k.record_stream(cur)
        return f_r + f_k

    return fn


def dryrun_rk_split(sim):
    """(f_split, f_fused): the forces on the state of sim's last step by
    the split and by the fused evaluation (``compute_forces`` with every
    category), as tensors on the run's device."""
    if sim._carry is None:
        raise ValueError("dryrun_rk_split: run the deck first (run 0)")
    s, neigh, _ = sim._carry
    ctx = sim._ctx
    f_split = make_split_force_fn(ctx)(s, neigh)
    f_fused = compute_forces(s, neigh, ctx, False, False)[0]
    return f_split, f_fused
