"""fix pour: pour granular particles into an insertion region.

The port of tpumd/md/fix_pour.py (FixPour ATOM mode, src/GRANULAR/
fix_pour.cpp): every ``nfreq`` steps (the time the previous batch takes
to fall clear of the insertion volume under gravity) up to ``nper``
spheres are placed at random non-overlapping positions inside a block or
z-cylinder region and released with the downward velocity of a free fall
from the region's top.  The RanPark draws run in the reference's order
(:363-700), with its 30 warm-up draws, and nper and nfreq follow its C
operation order, so the insertions are bit-identical to tpumd's for the
same seed.

Insertion is a host event at a segment's end (``host_every`` = nfreq): the
set-up is dropped (the atoms back in compact rows, their contact and wall
histories with them by tag), the new rows are appended, and the next
segment sets up anew.  The overlap test against the atoms near the region
runs on the host in numpy, as tpumd's does, over all of them at once.

As in tpumd: ATOM mode only (no molecule, rigid or shake templates), 3d,
fix gravity along -z, and at least one atom before the first insertion.
"""

from __future__ import annotations

import math
import time

import numpy as np

from tpumd_torch.core.region import BlockRegion, CylinderRegion
from tpumd_torch.md.fix_particle import add_atoms
from tpumd_torch.md.fix_sphere import FixGravity
from tpumd_torch.md.fixes import Fix
from tpumd_torch.utils.ranpark import RanPark

MY_4PI3 = 4.18879020478639098461


class FixPour(Fix):
    name = "pour"

    def __init__(self, regions, ninsert, ntype, seed, *args):
        """fix ID group pour N type seed region R [diam one D | range lo hi
        | poly n d1 p1 ...] [dens lo hi] [vol fraction attempts] [rate v]
        [vel vxlo vxhi vylo vyhi vz]; regions maps the region IDs."""
        self.ninsert = int(ninsert)
        self.ntype = int(ntype)
        self.rng = RanPark(int(seed))
        for _ in range(30):          # warm-up draws (fix_pour.cpp:166)
            self.rng.uniform()
        self.dstyle = "one"
        self.radius_one = self.radius_max = 0.5
        self.radius_lo = self.radius_hi = 0.0
        self.radius_poly = self.frac_poly = None
        self.density_lo = self.density_hi = 1.0
        self.volfrac = 0.25
        self.maxattempt = 50
        self.rate = 0.0
        self.vxlo = self.vxhi = self.vylo = self.vyhi = self.vz = 0.0
        self.region = None
        args = list(args)
        i = 0
        while i < len(args):
            k = args[i]
            if k == "region":
                self.region = regions[args[i + 1]]
                i += 2
            elif k == "diam" and args[i + 1] == "one":
                self.dstyle = "one"
                self.radius_one = self.radius_max = 0.5 * float(args[i + 2])
                i += 3
            elif k == "diam" and args[i + 1] == "range":
                self.dstyle = "range"
                self.radius_lo = 0.5 * float(args[i + 2])
                self.radius_hi = self.radius_max = 0.5 * float(args[i + 3])
                i += 4
            elif k == "diam" and args[i + 1] == "poly":
                self.dstyle = "poly"
                npoly = int(args[i + 2])
                vals = [float(v) for v in args[i + 3:i + 3 + 2 * npoly]]
                self.radius_poly = [0.5 * v for v in vals[0::2]]
                self.frac_poly = vals[1::2]
                self.radius_max = max(self.radius_poly)
                i += 3 + 2 * npoly
            elif k == "dens":
                self.density_lo = float(args[i + 1])
                self.density_hi = float(args[i + 2])
                i += 3
            elif k == "vol":
                self.volfrac = float(args[i + 1])
                self.maxattempt = int(args[i + 2])
                i += 3
            elif k == "rate":
                self.rate = float(args[i + 1])
                i += 2
            elif k == "vel":
                self.vxlo, self.vxhi = float(args[i + 1]), float(args[i + 2])
                self.vylo, self.vyhi = float(args[i + 3]), float(args[i + 4])
                self.vz = float(args[i + 5])
                i += 6
            else:
                raise NotImplementedError(
                    f"fix pour keyword {' '.join(args[i:i + 2])!r} is not "
                    "ported (region, diam one|range|poly, dens, vol, rate, "
                    "vel)")
        if self.region is None:
            raise ValueError("Must specify a region in fix pour")
        if isinstance(self.region, BlockRegion):
            self.region_style = 1
            self.xlo, self.ylo, self.zlo = self.region.lo
            self.xhi, self.yhi, self.zhi = self.region.hi
        elif isinstance(self.region, CylinderRegion) \
                and self.region.dim == 2:
            self.region_style = 2
            self.xc, self.yc = self.region.c1, self.region.c2
            self.rc = self.region.radius
            self.zlo, self.zhi = self.region.lo, self.region.hi
        else:
            raise ValueError(
                "Must use a block or z-cylinder region with fix pour")
        self.nper = None
        self._ninserted = 0
        self._pending_first = True
        self._nfirst = None
        # host milliseconds of each insertion (the set-up after it is
        # timed by the run)
        self.insert_ms: list[float] = []

    # ------------------------------------------------------------ setup
    def host_setup(self, sim):
        """nfreq and nper from the fix gravity and the timestep at the
        fix's definition, as the reference computes them in its
        constructor (fix_pour.cpp:175-255, in its operation order)."""
        if self.nper is not None:
            return
        gravs = [fx for fx in sim.fixes if isinstance(fx, FixGravity)]
        if len(gravs) != 1:
            raise ValueError("No fix gravity or more than one fix gravity"
                             " defined for fix pour")
        acc = gravs[0].acc
        if abs(acc[0]) > 1e-12 or abs(acc[1]) > 1e-12 or acc[2] >= 0:
            raise ValueError("Gravity must point in -z for fix pour")
        self.grav = acc[2] * sim.units.ftm2v
        v_rel = self.vz - self.rate
        delta = self.zhi - self.zlo
        t = (-v_rel - math.sqrt(v_rel * v_rel - 2.0 * self.grav * delta)) \
            / self.grav
        self.nfreq = max(1, int(t / sim.dt + 0.5))
        self.host_every = self.nfreq
        if self.region_style == 1:
            dy = max(self.yhi - self.ylo, 1.0)
            volume = (self.xhi - self.xlo) * dy * (self.zhi - self.zlo)
        else:
            volume = math.pi * self.rc * self.rc * (self.zhi - self.zlo)
        if self.dstyle == "poly":
            volume_one = 0.0
            for r, f in zip(self.radius_poly, self.frac_poly):
                volume_one += (MY_4PI3 * r * r * r) * f
        else:
            rm = self.radius_max
            volume_one = MY_4PI3 * rm * rm * rm
        self.nper = int(self.volfrac * volume / volume_one)
        if self.nper == 0:
            raise ValueError("Fix pour insertion count per timestep is 0")
        sim._log(f"Particle insertion: {self.nper} every {self.nfreq} "
                 f"steps, {self.ninsert} total")

    # ---------------------------------------------------------- insert
    def host_run_begin(self, sim):
        # the first batch goes in at the start of the first run (the
        # reference's next_reneighbor = ntimestep + 1 at construction)
        self.host_setup(sim)
        if self._pending_first and self._ninserted < self.ninsert:
            self._pending_first = False
            self._insert(sim)

    def host_end_of_step(self, sim):
        if self._ninserted < self.ninsert:
            self._insert(sim)

    def _radius_sample(self):
        if self.dstyle == "one":
            return self.radius_one
        if self.dstyle == "range":
            return self.radius_lo + self.rng.uniform() \
                * (self.radius_hi - self.radius_lo)
        value = self.rng.uniform()
        i, tot = 0, 0.0
        while tot < value:
            tot += self.frac_poly[i]
            i += 1
        return self.radius_poly[i - 1]

    def _xyz_random(self, h):
        if self.region_style == 1:
            cx = self.xlo + self.rng.uniform() * (self.xhi - self.xlo)
            cy = self.ylo + self.rng.uniform() * (self.yhi - self.ylo)
        else:
            while True:
                r1 = self.rng.uniform() - 0.5
                r2 = self.rng.uniform() - 0.5
                if r1 * r1 + r2 * r2 < 0.25:
                    break
            cx = self.xc + 2.0 * r1 * self.rc
            cy = self.yc + 2.0 * r2 * self.rc
        return np.array([cx, cy, h])

    def _first_fit(self, near, h, radtmp, budget):
        """(the first random point at height h, in the stream's order,
        where a sphere of radius radtmp overlaps no atom of near (a
        _NearAtoms), or None; the attempts it took, at most budget).  The
        points are drawn in batches ahead and tested at once; the stream
        is put back to just after the point taken, so it runs as the
        reference's attempt-by-attempt loop."""
        tries, batch = 0, 16
        while tries < budget:
            nb = min(batch, budget - tries)
            seeds, pts = [], []
            for _ in range(nb):
                seeds.append(self.rng.seed)
                pts.append(self._xyz_random(h))
            end = self.rng.seed
            pts = np.asarray(pts)
            free = ~near.overlaps(pts, radtmp)
            if free.any():
                k = int(np.argmax(free))
                self.rng.seed = seeds[k + 1] if k + 1 < nb else end
                return pts[k], tries + k + 1
            tries += nb
            batch = min(4 * batch, 1024)
        return None, tries

    def _insert(self, sim):
        t0 = time.perf_counter()
        sim.invalidate_ctx()
        s = sim.state
        step_ref = sim.step + 1   # the reference's ntimestep at pre_exchange
        if self._nfirst is None:
            self._nfirst = step_ref
        lo_c = self.zlo + (step_ref - self._nfirst) * sim.dt * self.rate
        hi_c = self.zhi + (step_ref - self._nfirst) * sim.dt * self.rate
        nnew = min(self.nper, self.ninsert - self._ninserted)

        x = s.x.cpu().numpy().astype(np.float64)
        rad = s.radius.cpu().numpy().astype(np.float64)
        ell = s.box.lengths_np()
        per = np.asarray([bool(p) for p in s.box.periodic])
        # the atoms overlapping the extended region
        delta = rad + self.radius_max
        if self.region_style == 1:
            near = ((x[:, 0] >= self.xlo - delta)
                    & (x[:, 0] <= self.xhi + delta)
                    & (x[:, 1] >= self.ylo - delta)
                    & (x[:, 1] <= self.yhi + delta))
        else:
            near = ((x[:, 0] - self.xc)**2 + (x[:, 1] - self.yc)**2
                    <= (self.rc + delta)**2)
        near &= (x[:, 2] >= lo_c - delta) & (x[:, 2] <= hi_c + delta)
        lo_b = np.array([x[near, 0].min(initial=0.0), x[near, 1].min(
            initial=0.0), lo_c]) - 1.0
        hi_b = np.array([x[near, 0].max(initial=0.0), x[near, 1].max(
            initial=0.0), hi_c]) + 1.0
        if self.region_style == 1:
            lo_b[:2] = np.minimum(lo_b[:2], [self.xlo, self.ylo])
            hi_b[:2] = np.maximum(hi_b[:2], [self.xhi, self.yhi])
        else:
            lo_b[:2] = np.minimum(lo_b[:2], [self.xc - self.rc,
                                             self.yc - self.rc])
            hi_b[:2] = np.maximum(hi_b[:2], [self.xc + self.rc,
                                             self.yc + self.rc])
        reach = self.radius_max + max(self.radius_max, float(
            rad[near].max(initial=0.0)))
        xnear = _NearAtoms(x[near], rad[near], lo_b, hi_b, reach, ell, per)

        new_rows = []   # (x, y, z, radius, vx, vy, vz, rmass)
        attempt = 0
        maxiter = nnew * self.maxattempt
        while len(new_rows) < nnew:
            rn = self.rng.uniform()
            h = hi_c - rn * rn * (hi_c - lo_c)
            radtmp = self._radius_sample()
            coord, tries = self._first_fit(xnear, h, radtmp,
                                           maxiter - attempt)
            attempt += tries
            if coord is None:
                break
            xnear.add(coord, radtmp)
            vx = self.vxlo + self.rng.uniform() * (self.vxhi - self.vxlo)
            vy = self.vylo + self.rng.uniform() * (self.vyhi - self.vylo)
            vzn = -math.sqrt(self.vz**2
                             + 2.0 * self.grav * (coord[2] - hi_c))
            dens = self.density_lo + self.rng.uniform() \
                * (self.density_hi - self.density_lo)
            rmass = 4.0 / 3.0 * math.pi * radtmp**3 * dens
            new_rows.append((*coord, radtmp, vx, vy, vzn, rmass))
        if not new_rows:
            return
        self._ninserted += len(new_rows)
        rows = np.asarray(new_rows, np.float64)
        # the reference inserts at pre_exchange, after the step's
        # initial_integrate: its new atoms take no drift and only the final
        # half-kick that step.  The insertion here is at the previous
        # segment's end, so the next step integrates them fully; starting
        # them half a step earlier gives the same state after it (exact in
        # free flight under constant gravity, as tpumd has it):
        #   x0 = x_ins - dt v_ins,  v0 = v_ins - dt/2 g
        dt = sim.dt
        rows[:, 0:3] -= dt * rows[:, 4:7]
        rows[:, 6] -= 0.5 * dt * self.grav / sim.units.ftm2v
        add_atoms(sim, rows[:, 0:3], np.full(len(rows), self.ntype),
                  rows[:, 4:7], gmask=1 | self.groupbit,
                  radius=rows[:, 3], rmass=rows[:, 7])
        self.insert_ms.append(1e3 * (time.perf_counter() - t0))
        sim._log(f"fix pour: inserted {len(new_rows)} atoms "
                 f"({self._ninserted}/{self.ninsert})")


class _NearAtoms:
    """The atoms an inserted sphere must not overlap, binned in cells of
    edge ``reach`` (at least any radius sum) over the box lo..hi, so that
    a point is tested only against the atoms of its 27 cells (the
    reference tests every atom near the region: the same pairs overlap).
    Points and atoms outside lo..hi fall in the edge cells; on a
    periodic axis every atom is tested."""

    def __init__(self, x, rad, lo, hi, reach, ell, per):
        self.ell, self.per = ell, per
        self.xyz = np.array(x, np.float64).reshape(-1, 3)
        self.rad = np.array(rad, np.float64).reshape(-1)
        self.binned = not per.any()
        if self.binned:
            self.lo, self.reach = lo, reach
            self.dims = np.maximum(((hi - lo) / reach).astype(int), 1)
            self.table = np.full((int(np.prod(self.dims)), 8), -1,
                                 np.int64)
            self.count = np.zeros(len(self.table), np.int64)
            for k in range(len(self.xyz)):
                self._bin(k)

    def _cells(self, pts):
        c = np.clip(((pts - self.lo) / self.reach).astype(int), 0,
                    self.dims - 1)
        return c

    def _bin(self, k):
        cx, cy, cz = self._cells(self.xyz[k:k + 1])[0]
        cid = (cz * self.dims[1] + cy) * self.dims[0] + cx
        n = self.count[cid]
        if n == self.table.shape[1]:
            self.table = np.concatenate(
                [self.table, np.full_like(self.table, -1)], axis=1)
        self.table[cid, n] = k
        self.count[cid] = n + 1

    def add(self, coord, radius):
        self.xyz = np.concatenate([self.xyz, coord[None, :]])
        self.rad = np.append(self.rad, radius)
        if self.binned:
            self._bin(len(self.xyz) - 1)

    def overlaps(self, pts, radius):
        """(len(pts),) whether a sphere of radius at each point overlaps
        an atom: |d|^2 <= (r + r_j)^2, d at the minimum image."""
        if not len(self.xyz):
            return np.zeros(len(pts), bool)
        if self.binned:
            c = self._cells(pts)
            offs = np.array([(i, j, k) for k in (-1, 0, 1)
                             for j in (-1, 0, 1) for i in (-1, 0, 1)])
            nbr = c[:, None, :] + offs[None]
            inside = np.all((nbr >= 0) & (nbr < self.dims), axis=2)
            nbr = np.clip(nbr, 0, self.dims - 1)
            cid = (nbr[..., 2] * self.dims[1] + nbr[..., 1]) \
                * self.dims[0] + nbr[..., 0]
            idx = np.where(inside[..., None], self.table[cid], -1).reshape(
                len(pts), -1)
            xj = self.xyz[np.maximum(idx, 0)]
            d = pts[:, None, :] - xj
        else:
            idx = None
            d = pts[:, None, :] - self.xyz[None]
            d = np.where(self.per, d - self.ell * np.round(d / self.ell), d)
        rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        radsum = radius + (self.rad if idx is None
                           else self.rad[np.maximum(idx, 0)])
        hit = rsq <= radsum * radsum
        if idx is not None:
            hit &= idx >= 0
        return hit.any(axis=1)
