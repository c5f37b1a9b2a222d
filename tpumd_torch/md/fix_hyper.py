"""Global hyperdynamics: fix hyper/global and the hyper command
(src/REPLICA/fix_hyper_global.cpp, src/REPLICA/hyper.cpp; the port of
tpumd/md/fix_hyper.py).

Voter's global-boost hyperdynamics: a bond list joins the atom pairs within
``cutbond`` of the last quenched state (r0 = their quenched separation).
Every step the bond of largest |r - r0| / r0 takes a bias force from
Vbias = Vmax (1 - Ebias^2 / q^2) (no bias where the largest strain reaches
q), and the hyper time advances by exp(Vbias / kT_equil) dt
(fix_hyper_global.cpp:227-330).

The bond list is built at the hyper command's set-up and at each event or
rebond (``build_bonds``, by tag, so that a re-bin of the grid leaves it
valid); it rides the fix's state on the device.  The bias in
post_force (the reference's pre_reverse timing: after the pair forces,
before the final integration) is a masked reduction whose index stays a
tensor: the largest strain, its bond's two atoms' rows and the two-row
scatter of the bias are device work with no read by the host.  Quenches
use the minimizer, which applies no fix, so they are bias-free as the
reference's (FixHyperGlobal sets no min hooks).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image, tag_rows
from tpumd_torch.md.fixes import Fix, fix_state

# the accumulators a rebuild of the bond list keeps
_ACC = ("t_hyper", "nobias", "negstrain", "nbias", "boost_sum")


class FixHyperGlobal(Fix):
    name = "hyper/global"

    def __init__(self, cutbond, qfactor, vmax, tequil, boltz=1.0):
        if cutbond < 0.0 or qfactor <= 0.0 or vmax < 0.0 or tequil <= 0.0:
            raise ValueError("Illegal fix hyper/global command")
        self.cutbond = float(cutbond)
        self.qfactor = float(qfactor)
        self.vmax = float(vmax)
        self.tequil = float(tequil)
        self.beta = 1.0 / (boltz * tequil)

    def _state(self, ti, tj, r0, like, acc=None):
        dev, dt = like.device, like.dtype
        fs = {"ti": torch.as_tensor(ti, dtype=torch.int64, device=dev),
              "tj": torch.as_tensor(tj, dtype=torch.int64, device=dev),
              "r0": torch.as_tensor(r0, dtype=dt, device=dev)}
        if acc is None:
            acc = {"t_hyper": torch.zeros((), dtype=dt, device=dev),
                   "boost_sum": torch.zeros((), dtype=dt, device=dev),
                   **{k: torch.zeros((), dtype=torch.int64, device=dev)
                      for k in ("nobias", "negstrain", "nbias")}}
        return {**fs, **{k: acc[k] for k in _ACC}}

    def build_bonds(self, sim, carry, acc=None):
        """The bond list of carry's (quenched) positions, by tag: every pair
        within cutbond, r0 its separation (build_bond_list,
        fix_hyper_global.cpp:335-440; tpumd/md/fix_hyper.py:51-90), in a
        new fix state that keeps the accumulators of ``acc``.  A
        minimum-image search over all pairs in blocks of rows on the
        positions' device (tpumd searches on the host), a read of each
        block's bonds."""
        s = carry[0]
        n = sim.natoms
        x = s.x[tag_rows(s.tag, n)].double()
        ell = s.box.lengths.double()
        per = torch.as_tensor(s.box.periodic, device=x.device)
        ti, tj, r0 = [], [], []
        block = max(1, 2**22 // max(n, 1))
        for a in range(0, n, block):
            d = x[a:a + block, None, :] - x[None, :, :]
            d = d - torch.where(per, torch.round(d / ell), 0.0) * ell
            r2 = torch.sum(d * d, dim=-1)
            j = torch.arange(n, device=x.device)
            i = torch.arange(a, min(a + block, n), device=x.device)
            hit = (r2 < self.cutbond ** 2) & (j[None, :] > i[:, None])
            ii, jj = torch.nonzero(hit, as_tuple=True)
            ti.append(ii + a + 1)
            tj.append(jj + 1)
            r0.append(torch.sqrt(r2[ii, jj]))
        return self._state(torch.cat(ti), torch.cat(tj), torch.cat(r0),
                           s.x, acc)

    def init_state(self, s, ctx):
        """No bonds until the hyper command builds them (an empty list is
        no bias)."""
        return self._state(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0), s.x)

    def post_force(self, s, fstate, ctx, xin=None):
        fs = fstate
        if fs["ti"].shape[0] == 0:
            # no bond: no bias, the clock runs at dt (as tpumd's all-padding
            # list does)
            return s, {**fs, "t_hyper": fs["t_hyper"] + ctx.dt,
                       "boost_sum": fs["boost_sum"] + 1.0}
        rows = tag_rows(s.tag, ctx.natoms)
        bi, bj = rows[fs["ti"] - 1], rows[fs["tj"] - 1]
        d = minimum_image(s.x[bi] - s.x[bj], s.box)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        strain = torch.abs(r - fs["r0"]) / fs["r0"]
        emax, m = torch.max(strain, dim=0)
        m1 = m.reshape(1)
        rmax, r0max = r[m1], fs["r0"][m1]
        ebias = (rmax - r0max) / r0max
        invq2 = 1.0 / (self.qfactor * self.qfactor)
        has_bias = emax < self.qfactor
        vbias = torch.where(has_bias, self.vmax * (1.0 - ebias * ebias
                                                    * invq2), 0.0)
        fbias = torch.where(has_bias, 2.0 * self.vmax * ebias * invq2, 0.0)
        dt_boost = torch.where(has_bias, torch.exp(self.beta * vbias), 1.0)
        df = d[m1] * (fbias / r0max / torch.clamp(rmax, min=1e-30))[:, None]
        f = s.f.index_add(0, torch.cat([bi[m1], bj[m1]]),
                          torch.cat([df, -df]))
        fs = dict(fs)
        one = has_bias.reshape(()).long()
        fs["t_hyper"] = fs["t_hyper"] + dt_boost.reshape(()) * ctx.dt
        fs["nobias"] = fs["nobias"] + (1 - one)
        fs["negstrain"] = fs["negstrain"] + (one & (ebias < 0.0).reshape(
            ()).long())
        fs["nbias"] = fs["nbias"] + one
        fs["boost_sum"] = fs["boost_sum"] + dt_boost.reshape(())
        return s.replace(f=f), fs


def _with_fix_state(sim, carry, fx, fstate):
    fstates = list(carry[2])
    fstates[list(sim._ctx.fixes).index(fx)] = fstate
    return carry[:2] + (tuple(fstates),)


def hyper(sim, nsteps, t_event, comp, *, fix_hyper=None, etol=1e-6,
          ftol=1e-6, maxiter=40, maxeval=50, rebond=0, log=None):
    """The hyper command's loop (src/REPLICA/hyper.cpp:150-240;
    tpumd/md/fix_hyper.py:155-250): biased dynamics in t_event segments,
    a quench and an event check after each, the bond list rebuilt at each
    event (and every ``rebond`` steps); ``comp`` is the compute
    event/displace, whose event store the loop binds.  Returns the
    statistics: nevent, nevent_atoms, steps, t_hyper, boost and, with a
    bias, nobias, negstrain, nbias and ave_boost."""
    from tpumd_torch.md.prd import PRD, EventDetector

    if rebond and rebond % t_event:
        raise ValueError("Hyper rebond must be multiple of t_event")
    det = comp.detector = EventDetector(comp.displace_dist)
    drv = PRD(sim, 1, det, 12345, etol=etol, ftol=ftol, maxiter=maxiter,
              maxeval=maxeval, temp=1.0, log=log)
    beginstep = step = sim.step

    def rebuilt(carry, q):
        if fix_hyper is None:
            return carry
        acc = carry[2][list(sim._ctx.fixes).index(fix_hyper)]
        return _with_fix_state(sim, carry, fix_hyper,
                               fix_hyper.build_bonds(sim, q, acc))

    carry = sim._carry
    q = drv._quench(carry, step)
    det.store(sim, q)
    carry = rebuilt(carry, q)
    nevent = nevent_atoms = istep = 0
    while istep < nsteps:
        carry = drv._dynamics(carry, step, t_event)
        step += t_event
        hot = carry
        q = drv._quench(carry, step)
        # the displaced atoms' count (hyper.cpp:204): one read
        ecount = int(torch.sum(det.displaced(sim, q)))
        event = ecount > 0
        if event:
            nevent += 1
            nevent_atoms += ecount
        if event or (rebond and step % rebond == 0):
            det.store(sim, q)
            hot = rebuilt(hot, q)
        carry = hot
        istep = step - beginstep

    drv._load(carry, step)
    sim.recompute_output()
    stats = dict(nevent=nevent, nevent_atoms=nevent_atoms, steps=istep,
                 quenches=drv.quenches, segments=drv.segments)
    if fix_hyper is None:
        stats.update(t_hyper=sim._ctx.dt * istep, boost=1.0)
        return stats
    fs = fix_state(sim, fix_hyper)
    t_hyper, nobias, negstrain, nbias, bsum = torch.stack(
        [fs[k].double() for k in _ACC]).tolist()
    stats.update(t_hyper=t_hyper,
                 boost=t_hyper / (sim._ctx.dt * istep) if istep else 1.0,
                 nobias=int(nobias), negstrain=int(negstrain),
                 nbias=int(nbias), nbonds=int(fs["ti"].shape[0]),
                 ave_boost=bsum / max(int(nbias) + int(nobias), 1))
    return stats
