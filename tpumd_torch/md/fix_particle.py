"""Atom insertion and deletion fixes: deposit and evaporate.

The port of tpumd/md/fix_particle.py (src/fix_deposit.cpp,
src/MC/fix_evaporate.cpp).  A change in the atom count is a host event:
the fix acts at its steps (``host_every``), drops the set-up
(``Simulation.invalidate_ctx``: the atoms back in compact rows, the
contact history and the fixes' per-atom tables with them) and edits the
state by tag; the next segment sets up anew.  Atomic and sphere systems;
molecule templates are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import PER_ATOM_FIELDS, map_per_atom
from tpumd_torch.md.fixes import Fix
from tpumd_torch.utils.ranpark import RanPark


def add_atoms(sim, x, types, v, gmask=1, **fields):
    """Append n atoms to the compact state after invalidate_ctx: positions
    x (n, 3), types, velocities v, group bits gmask, and any other
    per-atom field by name (radius, rmass, ...); the rest are zero,
    per-atom fix tables included.  Tags follow the largest; returns the
    first new tag."""
    s = sim.state
    n = len(x)
    tag0 = int(s.tag.max()) if s.tag.numel() else 0
    given = dict(fields, x=x, v=v, type=types,
                 tag=np.arange(tag0 + 1, tag0 + 1 + n))
    if s.gmask is not None:
        given["gmask"] = np.full(n, gmask)

    def ext(a, new):
        if new is None:
            return torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                               device=a.device)
        return torch.as_tensor(np.asarray(new), device=a.device).to(
            a.dtype).reshape((n,) + tuple(a.shape[1:]))

    upd = {k: torch.cat([getattr(s, k), ext(getattr(s, k), given.get(k))])
           for k in PER_ATOM_FIELDS if getattr(s, k) is not None}
    if s.peratom:
        upd["peratom"] = {k: torch.cat([a, ext(a, None)])
                          for k, a in s.peratom.items()}
    sim.state = s.replace(**upd)
    sim._natoms = None
    return tag0 + 1


def remove_atoms(sim, rows):
    """Delete the compact state's rows (after invalidate_ctx)."""
    keep = torch.ones(sim.state.tag.shape[0], dtype=torch.bool)
    keep[torch.as_tensor(rows, dtype=torch.long)] = False
    idx = torch.nonzero(keep).flatten().to(sim.device)
    sim.state = map_per_atom(sim.state, lambda a: a[idx])
    sim._natoms = None


class FixDeposit(Fix):
    """fix deposit N type M seed region R [vx lo hi] [vy lo hi] [vz lo hi]
    [near R] [attempt Q] [units box|lattice]: one atom every M steps at a
    random point of the region (RanPark stream), a point nearer than
    ``near`` to any atom rejected, up to ``attempt`` tries (tpumd/md/
    fix_particle.py:83-168, atoms only)."""

    name = "deposit"

    def __init__(self, ntotal, itype, nevery, seed, region, vx=(0, 0),
                 vy=(0, 0), vz=(0, 0), near=0.0, maxattempt=10):
        self.ntotal = int(ntotal)
        self.itype = int(itype)
        self.host_every = max(int(nevery), 1)
        self.region = region
        self.vx, self.vy, self.vz = vx, vy, vz
        self.near = float(near)
        self.maxattempt = int(maxattempt)
        self._rng = RanPark(int(seed))
        self.ninserted = 0

    def host_end_of_step(self, sim):
        if self.ninserted >= self.ntotal:
            return
        lo, hi = self.region.bounding_box()
        sim.invalidate_ctx()
        s = sim.state
        xv = s.x.cpu().numpy().astype(np.float64)
        for _ in range(self.maxattempt):
            pt = np.array([lo[d] + self._rng.uniform() * (hi[d] - lo[d])
                           for d in range(3)])
            if not self.region.inside(pt[None, :])[0]:
                continue
            if self.near > 0 and len(xv) and (np.linalg.norm(
                    xv - pt, axis=-1) < self.near).any():
                continue
            break
        else:
            sim._log(f"WARNING: fix deposit failed to insert at step "
                     f"{sim.step}")
            return
        v = np.array([r_[0] + self._rng.uniform() * (r_[1] - r_[0])
                      for r_ in (self.vx, self.vy, self.vz)])
        fields = {}
        if s.radius is not None:
            # a sphere of diameter 1 and density 1, as create_atoms makes
            fields = {"radius": [0.5], "rmass": [4.0 / 3.0 * np.pi / 8.0]}
        add_atoms(sim, pt[None, :], [self.itype], v[None, :],
                  gmask=1 | self.groupbit, **fields)
        self.ninserted += 1


class FixEvaporate(Fix):
    """fix evaporate N M region R seed: every N steps, delete up to M atoms
    of the group inside the region, picked with RanPark (tpumd/md/
    fix_particle.py:171-209)."""

    name = "evaporate"

    def __init__(self, nevery, nflux, region, seed):
        self.host_every = max(int(nevery), 1)
        self.nflux = int(nflux)
        self.region = region
        self._rng = RanPark(int(seed))
        self.ndeleted = 0

    def _candidates(self, s):
        x = s.x.cpu().numpy().astype(np.float64)
        inside = (s.tag > 0) & self.group_sel(s)
        return np.nonzero(inside.cpu().numpy() & self.region.inside(x))[0]

    def _draw(self, cand):
        pool, rows = list(cand), []
        for _ in range(min(self.nflux, len(pool))):
            k = int(self._rng.uniform() * len(pool)) % len(pool)
            rows.append(pool.pop(k))
        return rows

    def host_end_of_step(self, sim):
        cand = self._candidates(sim.state)
        if len(cand) == 0:
            return
        # tpumd draws once on the carried state's rows and again on the
        # compact rows after invalidating; the port keeps both draws so
        # that the RanPark streams stay in step
        self._draw(cand)
        sim.invalidate_ctx()
        rows = self._draw(self._candidates(sim.state))
        if rows:
            remove_atoms(sim, rows)
            self.ndeleted += len(rows)
