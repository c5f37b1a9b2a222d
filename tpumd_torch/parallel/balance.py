"""Load balance: recursive coordinate bisection over atom rows.

The port of tpumd/parallel/balance.py (src/balance.cpp, src/rcb.cpp).  On
the cell grid the work is per grid slot, so equal slot ranges are equal
work by construction; on the matrix engine the per-atom arrays are rows,
and ``balance ... rcb`` reorders them so that each block of equal row
count is a spatially compact subdomain (RCB::compute, then
Irregular::migrate_atoms).  The shift style and ``balance x|y|z`` reduce
to the same permutation: a sort by the shifted dims with equal-count cuts
is the converged shift.

The part count is an argument: by default the number of cards of the
run's device (1 on the CPU and on one card), where tpumd takes its JAX
device count.  The orders and figures are host numpy, as in tpumd, and
equal to its own on the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import map_per_atom


def rcb_order(x: np.ndarray, nparts: int) -> np.ndarray:
    """Row permutation: recursive median bisection along the longest
    extent until nparts equal-count parts; part k is
    order[k * n // nparts:(k + 1) * n // nparts]."""

    def rec(idx, parts):
        if parts == 1:
            return [idx]
        lo_parts = parts // 2
        frac = lo_parts / parts
        ext = x[idx].max(axis=0) - x[idx].min(axis=0)
        dim = int(np.argmax(ext))
        srt = idx[np.argsort(x[idx, dim], kind="stable")]
        cut = int(round(len(srt) * frac))
        return rec(srt[:cut], lo_parts) + rec(srt[cut:], parts - lo_parts)

    return np.concatenate(rec(np.arange(len(x)), nparts))


def dim_sort_order(x: np.ndarray, dims: str) -> np.ndarray:
    """``balance x y ...``: a lexicographic sort by the listed dims (the
    first the slowest), whose equal row blocks are the converged cuts."""
    return np.lexsort([x[:, "xyz".index(d)] for d in reversed(dims)])


def imbalance(counts: np.ndarray) -> float:
    """max/mean imbalance factor (Balance::imbalance_factor)."""
    mean = counts.mean()
    return float(counts.max() / mean) if mean > 0 else 1.0


def slab_imbalance(x: np.ndarray, order: np.ndarray, nparts: int) -> float:
    """The largest span, along the cloud's longest extent, of the
    equal-count row blocks under order, in units of 1/nparts of that
    extent: 1 for compact blocks, about nparts for scrambled rows.  The
    same figure before and after a reorder says what the reorder did."""
    n = len(x)
    ext_dim = int(np.argmax(x.max(0) - x.min(0)))
    lo, hi = x[:, ext_dim].min(), x[:, ext_dim].max() + 1e-12
    edges = [n * k // nparts for k in range(nparts + 1)]
    spans = []
    for a, b in zip(edges[:-1], edges[1:]):
        xb = np.sort(x[order[a:b], ext_dim])
        spans.append((xb[-1] - xb[0]) * nparts / (hi - lo))
    return float(np.max(spans))


def part_count(device) -> int:
    """The default part count of a run on one process: the cards of a
    CUDA device's host, 1 on the CPU (``sim_parts`` takes a process
    group's size instead)."""
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def sim_parts(sim) -> int:
    """The part count of sim's run: the ranks of the process group it is
    decomposed over (tpumd takes len(jax.devices())), else
    ``part_count``."""
    if sim.mesh.distributed:
        return sim.mesh.size
    return part_count(sim.device)


def balance_atoms(sim, style: str, dims: str = "", nparts: int | None = None):
    """Permute the rows of sim's atoms into equal-count spatial blocks
    (style "rcb", or "shift" by dims, by default the longest extent) and
    drop the set-up; returns (imbalance before, after), the same figure
    (``slab_imbalance``) over the rows before and after.  A running state
    is compacted first (``invalidate_ctx``), so the rows are the live
    atoms.  Every per-atom field moves with its row (``map_per_atom``:
    the special lists, ``peratom``'s tables of fixes and styles); the
    fixes' other state is kept by tag."""
    if nparts is None:
        nparts = sim_parts(sim)
    sim.invalidate_ctx()
    s = sim.state
    x = s.x.detach().cpu().numpy().astype(np.float64)
    before = slab_imbalance(x, np.arange(len(x)), nparts)
    if style == "rcb":
        order = rcb_order(x, nparts)
    else:
        ext_dim = int(np.argmax(x.max(0) - x.min(0)))
        order = dim_sort_order(x, dims or "xyz"[ext_dim])
    after = slab_imbalance(x, order, nparts)
    pj = torch.as_tensor(order, device=s.x.device)
    sim.state = map_per_atom(s, lambda a: a[pj])
    return before, after
