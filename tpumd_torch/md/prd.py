"""Parallel replica dynamics: the prd command (src/REPLICA/prd.cpp), and
the event detection that prd, tad and hyper share (compute event/displace,
src/REPLICA/compute_event_displace.cpp).

The port of tpumd/md/prd.py.  R replicas of one system search for an
infrequent event: each runs ``t_event`` steps, is quenched (the minimize
command's minimizer) and compared with the last event's quenched
coordinates; where some atom moved more than the displacement cutoff, an
event is declared, the clock advances by the replicas' summed time less
the random part of the segment after the event, the event replica's state
is shared with every replica, correlated events are searched on it for
``t_corr`` steps, and the replicas dephase again with new velocities.  The
clock, the coincident-event choice and the correlated windows are the
reference's arithmetic (prd.cpp:289-419, fix_event_prd.cpp:45-53), as in
tpumd.

Replicas are snapshots of the one simulation's carry (state, neighbour
structure, fix states) kept on the device; loading one clones it, so that
the list's in-place refreshes never reach a stored snapshot, and re-bins it
where the simulation's neighbour capacities grew since it was taken.  The
host reads the device only where the reference decides on the host: the
event check (one flag), the dephase temperature, the velocities' draw (the
positions the loop-geom generator hashes) and the log row.  The dephase
velocities come from the loop-geom generator seeded by each replica's
RanMars stream, as tpumd draws them (the reference's default draws one
serial stream per atom).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tpumd_torch.core.state import tag_rows
from tpumd_torch.core.velocity_cmd import velocity_create_geom
from tpumd_torch.utils.ranmars import RanMars
from tpumd_torch.utils.ranpark import RanPark

MAXSMALLINT = 2**31 - 1
# the per-atom table that carries the hot velocities through a quench's
# re-bins (md/minimize.py keeps the state's other tables)
_HOT_V = "prd hot v"


def clone_tree(obj):
    """A copy of a carry with every tensor cloned (dataclasses, named and
    plain tuples, lists and dicts walked); anything else is shared."""
    if torch.is_tensor(obj):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: clone_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(clone_tree(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(clone_tree(v) for v in obj)
    if isinstance(obj, dict):
        return {k: clone_tree(v) for k, v in obj.items()}
    return obj


def fits(ctx, neigh) -> bool:
    """Whether a stored neighbour structure has the shapes of ctx's
    config (a regrow since it was taken changes them)."""
    cfg = ctx.neigh_cfg
    if ctx.is_cellgrid:
        return neigh.valid.shape[0] == cfg.capacity and (
            neigh.pairs is None or neigh.pairs.shape[1] == ctx.pairlist_k)
    return getattr(neigh, "idx", None) is not None \
        and neigh.idx.shape[1] == cfg.kmax


def unwrapped_tagged(sim, carry) -> torch.Tensor:
    """(N, 3) f64 unwrapped positions in tag order, on the device."""
    s = carry[0]
    xu = s.x.double() + s.image.double() * s.box.lengths.double()
    return xu[tag_rows(s.tag, sim.natoms)]


def _set_velocities(sim, carry, v_tagged):
    """carry with tag-ordered velocities (host array) written into its
    state's rows (zero on empty slots)."""
    s = carry[0]
    vt = torch.as_tensor(v_tagged, dtype=s.v.dtype, device=s.v.device)
    v = torch.where((s.tag > 0)[:, None], vt[(s.tag.long() - 1).clamp(
        min=0)], 0)
    return (s.replace(v=v),) + tuple(carry[1:])


def _temperature(sim, carry) -> float:
    """The carry's temperature with dim * N - dim degrees of freedom (one
    read)."""
    s = carry[0]
    valid = s.tag > 0
    m = torch.as_tensor(sim.mass, dtype=torch.float64,
                        device=s.v.device)[s.type.long()]
    mvv = float(torch.sum(torch.where(valid, m * torch.sum(
        s.v.double() ** 2, dim=1), 0)))
    dof = sim.dimension * sim.natoms - sim.dimension
    return sim.units.mvv2e * mvv / (dof * sim.units.boltz)


class EventDetector:
    """compute event/displace: an event where some atom moved more than
    displace_dist since the last stored event
    (src/REPLICA/compute_event_displace.cpp:86-140).  The stored positions
    stay on the device; a check is one read."""

    def __init__(self, displace_dist: float):
        self.distsq = float(displace_dist) ** 2
        self.xevent = None   # (N, 3) f64 unwrapped, tag order, device

    def displaced(self, sim, carry) -> torch.Tensor:
        """(N,) bool on the device: the atoms past the cutoff."""
        d = unwrapped_tagged(sim, carry) - self.xevent
        return torch.sum(d * d, dim=1) > self.distsq

    def check(self, sim, carry) -> bool:
        if self.xevent is None:
            return False
        return bool(torch.any(self.displaced(sim, carry)))

    def store(self, sim, carry):
        self.xevent = unwrapped_tagged(sim, carry)


class PRD:
    """The prd command's loop over replica snapshots of one simulation."""

    def __init__(self, sim, nreplica, detector, seed, *,
                 etol=1e-6, ftol=1e-6, maxiter=40, maxeval=50,
                 temp=None, dist="gaussian", stepmode=0, log=None):
        if sim._ctx is None:
            sim.setup()
        self.sim = sim
        self.nrep = int(nreplica)
        self.det = detector
        self.minargs = (etol, ftol, maxiter, maxeval)
        self.random_select = RanPark(seed)
        self.random_clock = RanPark(seed + 1000)
        self.random_dephase = [RanMars(seed + r) for r in range(self.nrep)]
        self.temp_flag = temp is not None
        self.temp_dephase = temp
        self.dist = dist
        self.stepmode = stepmode
        self.log = log or (lambda *a: None)
        self.events = []        # one dict per logged event line
        self.clock = 0          # the loop's stepmode clock (prd.cpp:289)
        self.event_clock = 0    # the logged clock (fix_event_prd.cpp:52)
        self.event_number = 0
        self.event_timestep = 0
        self.ncoincident = 0
        self.replica_number = 0
        self.t_corr = 0
        self.quenches = 0
        self.segments = 0
        self._t0 = time.perf_counter()

    # -- replica load/store

    def _load(self, carry, step):
        """Make a clone of carry the simulation's state at step; re-binned
        where the capacities grew since it was stored."""
        sim = self.sim
        carry = clone_tree(carry)
        sim._carry = carry
        if len(carry) == 3 and not fits(sim._ctx, carry[1]):
            sim.rebin_grown(carry)
        sim.state = sim._carry[0]
        sim._energies_of = None
        sim.step = step

    def _quench(self, carry, step):
        """The carry minimized, with its hot velocities restored (the
        reference's line-search minimizers leave v alone, prd.cpp:536-580)
        by tag through the minimization's re-bins."""
        s = carry[0]
        self._load((s.replace(peratom={**(s.peratom or {}), _HOT_V: s.v}),)
                   + tuple(carry[1:]), step)
        verbose, self.sim.verbose = self.sim.verbose, False
        try:
            self.sim.minimize(*self.minargs)
        finally:
            self.sim.verbose = verbose
        self.quenches += 1
        q = self.sim._carry
        table = dict(q[0].peratom)
        v = table.pop(_HOT_V)
        return (q[0].replace(v=v, peratom=table or None),) + tuple(q[1:])

    def _dynamics(self, carry, step, nsteps):
        self._load(carry, step)
        self.sim.run(nsteps)
        self.segments += 1
        return self.sim._carry

    def _log_event(self, corrflag):
        row = dict(step=self.event_timestep, clock=self.event_clock,
                   event=self.event_number, correlated=corrflag,
                   coincident=self.ncoincident,
                   replica=self.replica_number,
                   cpu=time.perf_counter() - self._t0)
        self.events.append(row)
        self.log(f"{row['step']} {row['cpu']:.3f} {row['clock']} "
                 f"{row['event']} {row['correlated']} "
                 f"{row['coincident']} {row['replica']}")

    def _share_event(self, replicas, ireplica, flag, decrement, step):
        """share_event (prd.cpp:645-700): every replica takes the event
        replica's state; the logged clock advances (store_event_prd,
        fix_event_prd.cpp:48-53), apart from the loop's own clock."""
        src = replicas[ireplica]
        for r in range(len(replicas)):
            replicas[r] = src
        corr_adjust = self.t_corr
        if self.event_number < 1 or flag == 2:
            corr_adjust = 0
        delta = step - self.event_timestep - corr_adjust
        if flag != 2:
            delta *= self.nrep
            if delta > 0:
                delta -= decrement
        delta += corr_adjust
        self.event_timestep = step
        self.event_clock += delta
        self.event_number += 1
        if flag != 0:
            self.replica_number = ireplica
            self.correlated_event = 1 if flag == 2 else 0
        if flag == 0:
            self.event_number -= 1
        self.det.store(self.sim, src)

    def _dephase(self, replicas, step, n_dephase, t_dephase):
        """prd.cpp:463-505: each replica's velocity randomization runs,
        retried until they stay in the basin."""
        for r in range(self.nrep):
            carry = replicas[r]
            for _ in range(n_dephase):
                state_dephase = carry
                while True:
                    seed = int(self.random_dephase[r].uniform()
                               * MAXSMALLINT) or 1
                    carry = self._randomize_velocities(carry, seed)
                    carry = self._dynamics(carry, step, t_dephase)
                    hot = carry
                    q = self._quench(carry, step + t_dephase)
                    if self.det.check(self.sim, q):
                        carry = state_dephase
                    else:
                        carry = hot
                        break
                if not self.temp_flag:
                    self.temp_dephase = _temperature(self.sim, carry)
            replicas[r] = carry

    def _randomize_velocities(self, carry, seed):
        """New velocities at temp_dephase from the loop-geom generator,
        hashing each atom's position (the positions' one read)."""
        sim = self.sim
        s = carry[0]
        rows = tag_rows(s.tag, sim.natoms)
        x = s.x[rows].double().cpu().numpy()
        m = sim.mass[s.type[rows].cpu().numpy()]
        v = velocity_create_geom(
            x, m, self.temp_dephase, seed, boltz=sim.units.boltz,
            mvv2e=sim.units.mvv2e, dist=self.dist, dimension=sim.dimension)
        return _set_velocities(sim, carry, v)

    # -- the loop (prd.cpp:283-419)

    def run(self, nsteps, t_event, n_dephase, t_dephase, t_corr):
        if nsteps % t_event:
            raise ValueError("PRD nsteps must be multiple of t_event")
        if t_corr % t_event:
            raise ValueError("PRD t_corr must be multiple of t_event")
        self.t_corr = t_corr
        sim = self.sim
        beginstep = step = sim.step

        # the initial quench, shared as event 0
        q = self._quench(sim._carry, step)
        replicas = [q] * self.nrep
        self._share_event(replicas, 0, 0, 0, step)
        self._log_event(0)
        if not self.temp_flag:
            self.temp_dephase = _temperature(sim, replicas[0])

        istep = 0
        while istep < nsteps:
            self._dephase(replicas, step, n_dephase, t_dephase)
            istep = (step - beginstep) if self.stepmode == 0 else self.clock

            ireplica = -1
            while istep < nsteps:
                hot = [None] * self.nrep
                quenched = [None] * self.nrep
                flags = [False] * self.nrep
                for r in range(self.nrep):
                    hot[r] = self._dynamics(replicas[r], step, t_event)
                    quenched[r] = self._quench(hot[r], step + t_event)
                    flags[r] = self.det.check(sim, quenched[r])
                step += t_event
                self.clock += t_event * self.nrep
                evs = [r for r in range(self.nrep) if flags[r]]
                self.ncoincident = len(evs)
                if evs:
                    if len(evs) > 1:
                        iwhich = int(len(evs)
                                     * self.random_select.uniform()) + 1
                        ireplica = evs[iwhich - 1]
                    else:
                        ireplica = evs[0]
                    replicas = quenched
                    break
                replicas = hot
                istep = (step - beginstep) if self.stepmode == 0 \
                    else self.clock
            if ireplica < 0:
                break

            # the clock less the random in-segment event time
            # (prd.cpp:306-316)
            frac_t_event = t_event
            for _ in range(self.ncoincident):
                frac_rand = int(self.random_clock.uniform() * t_event)
                frac_t_event = min(frac_t_event, frac_rand)
            decrement = (t_event - frac_t_event) * self.nrep
            self.clock -= decrement

            self._share_event(replicas, ireplica, 1, decrement, step)
            self._log_event(0)

            # correlated events: every replica advances, only the event
            # replica is checked; time counts once (prd.cpp:346-368)
            corr_endstep = step + t_corr
            while step < corr_endstep:
                if step == beginstep + nsteps:
                    break
                corr_hit = False
                for r in range(self.nrep):
                    hot_r = self._dynamics(replicas[r], step, t_event)
                    if r == ireplica:
                        q = self._quench(hot_r, step + t_event)
                        corr_hit = self.det.check(sim, q)
                        replicas[r] = q if corr_hit else hot_r
                    else:
                        replicas[r] = hot_r
                step += t_event
                self.clock += t_event
                if corr_hit:
                    self._share_event(replicas, ireplica, 2, 0, step)
                    self._log_event(1)
                    corr_endstep = step + t_corr

            if t_corr > 0:
                src = replicas[ireplica]
                for r in range(self.nrep):
                    replicas[r] = src
            if not self.temp_flag:
                self.temp_dephase = _temperature(sim, replicas[ireplica])
            istep = (step - beginstep) if self.stepmode == 0 else self.clock

        # the simulation goes on from replica 0's state at the last step
        self._load(replicas[0], step)
        sim.recompute_output()
        return self.events


def prd(sim, nsteps, t_event, n_dephase, t_dephase, t_corr, displace_dist,
        seed, nreplica, **kw):
    det = EventDetector(displace_dist)
    runner = PRD(sim, nreplica, det, seed, **kw)
    return runner.run(nsteps, t_event, n_dephase, t_dephase, t_corr)
