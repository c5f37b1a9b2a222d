"""Temperature-accelerated dynamics (tad command) — src/REPLICA/tad.cpp.

One trajectory runs at an elevated temperature ``temphi``; every
``t_event`` steps it is quenched and compared to the current basin's
quenched coordinates (compute event/displace).  Each detected event's
barrier is measured with a NEB between the basin minimum and the event
minimum, and its waiting time is extrapolated to ``templo`` through the
Arrhenius factor exp(Eb*(1/kTlo - 1/kThi)).  The trajectory reverts
(with time-reversed velocities, tad.cpp:757-800 store/revert_state) and
keeps searching the SAME basin until the stopping criterion
deltstop = deltconf*(deltfirst/deltconf)^(Tlo/Thi) confirms, with
confidence 1-delta_conf, that the earliest low-temperature event has
been found (nu_min = 1/tmax prefactor bound); then the system advances
through that event and the low-T clock jumps by its extrapolated
waiting time.

The port of tpumd/md/tad.py: the dynamics segments and quenches are
PRD's (md/prd.py), each candidate event's barrier comes from the port's NEB
over the band between the basin's and the event's minima (md/neb.py), and
the bookkeeping (tad.cpp:240-360 event-list loop, compute_tlo:860-890,
check_confidence:738-750) is tpumd's, on the host.
"""

from __future__ import annotations

import time

import numpy as np

from tpumd_torch.core.state import tag_rows
from tpumd_torch.md.prd import PRD


class TAD(PRD):
    """TAD orchestrator: reuses PRD's quench/dynamics plumbing on a
    single trajectory plus the NEB band for barrier measurement."""

    def __init__(self, sim, detector, templo, temphi, delta_conf, tmax,
                 *, etol=0.1, ftol=0.1, maxiter=40, maxeval=50,
                 etol_neb=0.01, ftol_neb=0.01, n1_neb=100, n2_neb=100,
                 nevery_neb=10, neb_replicas=4, log=None):
        super().__init__(sim, 1, detector, 12345, etol=etol, ftol=ftol,
                         maxiter=maxiter, maxeval=maxeval, temp=1.0,
                         log=log)
        self.templo, self.temphi = float(templo), float(temphi)
        boltz = sim.units.boltz
        self.delta_beta = (1.0 / self.templo - 1.0 / self.temphi) / boltz
        self.ratio_beta = self.templo / self.temphi
        self.deltconf = -np.log(delta_conf) * tmax / sim._ctx.dt
        self.nebargs = dict(etol=etol_neb, ftol=ftol_neb, n1=n1_neb,
                            n2=n2_neb, nevery=nevery_neb,
                            nreplica=neb_replicas)
        self.tlo = 0.0
        self.ebarrier = 0.0
        self.event_rows = []
        self.nebs = []          # each candidate's NEB result

    def _log_row(self, step, n, m, status, ebarrier, tfrac, tlo, deltlo):
        row = dict(step=step, event=n, ievent=m, status=status,
                   barrier=ebarrier, margin=tfrac, t_lo=tlo,
                   delt_lo=deltlo, cpu=time.perf_counter() - self._t0)
        self.event_rows.append(row)
        self.log(f"{step} {row['cpu']:.3f} {n} {m} {status} "
                 f"{ebarrier:.3f} {tfrac:.3f} {tlo:.3f} {deltlo:.3f}")

    def _perform_neb(self, basin_q, candidate_q, step):
        """The NEB between the basin minimum and the candidate event's
        minimum over the band (tad.cpp:584-690); returns the forward
        barrier.  The final coordinates go by tag."""
        from tpumd_torch.md.neb import neb
        self._load(basin_q, step)
        s = candidate_q[0]
        x = s.x[tag_rows(s.tag, self.sim.natoms)].double().cpu().numpy()
        tags = np.arange(1, x.shape[0] + 1)
        res = neb(self.sim, self.nebargs["etol"], self.nebargs["ftol"],
                  self.nebargs["n1"], self.nebargs["n2"],
                  self.nebargs["nevery"], tags, x,
                  nreplica=self.nebargs["nreplica"], log=lambda *a: None)
        self.nebs.append(res)
        return float(res["ebf"])

    def run(self, nsteps, t_event):
        sim = self.sim
        beginstep = sim.step
        endstep = beginstep + nsteps
        step = beginstep

        hot = sim._carry
        basin_q = self._quench(hot, step)
        self.det.store(sim, basin_q)
        self.event_timestep = step
        self.event_number = 0
        self._log_row(step, 0, 0, "E ", 0.0, 0.0, self.tlo, 0.0)

        carry = hot
        revert = hot          # store_state target (tad.cpp:280)
        while step < endstep:
            events = []       # (q, hot, step) candidates in this basin
            confident = False
            deltfirst = 0.0
            event_first = -1
            while step < endstep:
                event = False
                while step < endstep:
                    carry = self._dynamics(carry, step, t_event)
                    step += t_event
                    hot = carry
                    q = self._quench(hot, step)
                    if self.det.check(sim, q):
                        event = True
                        break
                    carry = hot            # restore hot state
                    revert = hot           # store_state
                if not event:
                    break

                # add_event + perform_neb + compute_tlo
                events.append(dict(q=q, hot=hot, step=step))
                ievent = len(events) - 1
                ebarrier = self._perform_neb(basin_q, q, step)
                events[ievent]["ebarrier"] = ebarrier
                delthi = events[ievent]["step"] - self.event_timestep
                deltlo = delthi * np.exp(ebarrier * self.delta_beta)
                events[ievent]["tlo"] = self.tlo + deltlo
                events[ievent]["deltlo"] = deltlo
                status = "D "
                if ievent == 0 or deltlo < deltfirst:
                    deltfirst = deltlo
                    event_first = ievent
                    status = "DF"
                deltstop = self.deltconf * (deltfirst / self.deltconf) \
                    ** self.ratio_beta
                tfrac = delthi / deltstop if ievent > 0 else 0.0
                self._log_row(events[ievent]["step"],
                              self.event_number, ievent, status,
                              ebarrier, tfrac, self.tlo, deltlo)

                confident = deltstop < step - self.event_timestep
                if confident:
                    break
                # revert_state: pre-event hot state, time-reversed
                # velocities (tad.cpp:778-800)
                s_rev = revert[0]
                carry = (s_rev.replace(v=-s_rev.v),) + tuple(revert[1:])
            if not confident:
                break

            # perform_event (tad.cpp:805-840)
            ev = events[event_first]
            step = ev["step"]
            self.tlo = ev["tlo"]
            self.ebarrier = ev["ebarrier"]
            self.event_number += 1
            self.event_timestep = step
            basin_q = ev["q"]
            self.det.store(sim, basin_q)
            self._log_row(step, self.event_number, event_first, "E ",
                          self.ebarrier, 0.0, self.tlo, deltfirst)
            carry = ev["hot"]
            revert = ev["hot"]

        self._load(carry, step)
        sim.recompute_output()
        return self.event_rows
