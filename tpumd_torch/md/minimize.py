"""Energy minimization: the minimize command's styles fire, cg, sd,
quickmin and hftn.

The port of tpumd/md/minimize.py (the reference's src/min_cg.cpp,
min_sd.cpp, min_linesearch.cpp, min_fire.cpp, min_quickmin.cpp,
min_hftn.cpp), computing what tpumd computes: FIRE's damped dynamics;
cg (tpumd's Polak-Ribiere form, reset to steepest descent when the
direction turns uphill) and sd with a line search that starts where no
atom moves more than dmax = 0.1 and halves the step until the energy
drops, at most 20 times; quickmin's projected Euler steps; hftn's trust
region around an inner CG of finite-difference Hessian products.  Where
tpumd runs nested ``while_loop``s on the device, the port runs a Python
loop that reads the device once per force evaluation (the energy and
|f|^2 in one transfer, ``Evaluator.reads``).

Every evaluation moves the atoms as a step of the run would: the rebuild
schedule and its displacement check, else on the cell grid a refresh of
the pair list where it is stale; a rebuild or refresh that overflows its
capacity raises.  A re-bin reorders the atoms, so the vectors a style
carries from one evaluation to the next (cg's direction, FIRE's
velocities, hftn's iterates) ride ``MDState.peratom`` through it; a trial
that a line search rejects leaves its re-bin behind with it.  As tpumd's,
the minimizer applies no fix.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from tpumd_torch.md.verlet import _rebuild, compute_forces, \
    decide_rebuild, refresh_list

DMAX = 0.1              # Min::dmax, the most an atom moves in a trial
FIRE_PARAMS = dict(delaystep=5, dt_grow=1.1, dt_shrink=0.5, alpha0=0.25,
                   alpha_shrink=0.99, tmax=10.0)
MEPS = 2.220446049250313e-16
MIN_ETOL_MAG = 1.0e-8
# the per-atom tables of the vectors a style carries through a re-bin
_KEY = "minimize "


class Evaluator:
    """Energy and forces of a simulation's state at given positions.
    ``evals`` counts force evaluations, ``reads`` the host's reads of the
    device (energies, rebuild checks, overflow flags, hftn's dot
    products), ``rebins`` the re-bins and rebuilds of the list."""

    def __init__(self, sim):
        self.sim = sim
        self.evals = 0
        self.reads = 0
        self.rebins = 0

    def read(self, t) -> list:
        """t (a tensor of a few scalars) on the host, counted."""
        self.reads += 1
        return t.detach().reshape(-1).double().tolist()

    def lowered(self, v: float) -> float:
        """v rounded to the run's dtype, where tpumd compares energies."""
        if self.sim.dtype == torch.float32:
            return float(np.float32(v))
        return v

    def __call__(self, s, neigh, x, carry=None):
        """(s at x with its forces, neigh, the energy (() tensor), carry
        (name -> (N, ...) tensors, in the atoms' new order), [energy,
        |f|^2] on the host)."""
        carry = carry or {}
        ctx = self.sim._ctx
        s = s.replace(x=x, peratom={**(s.peratom or {}), **{
            _KEY + k: v for k, v in carry.items()}})
        neigh = neigh.replace(ago=neigh.ago + 1)
        cfg = ctx.neigh_cfg
        if cfg.check and neigh.ago >= cfg.delay and neigh.ago % cfg.every == 0:
            self.reads += 1           # the displacement check's flag
        if decide_rebuild(s, neigh, ctx):
            s, neigh = _rebuild(s, neigh, ctx)
            self.rebins += 1
        elif ctx.pairlist_refresh:
            neigh = refresh_list(s, neigh, ctx)
        f, energies, _, _, neigh = compute_forces(s, neigh, ctx, eflag=True,
                                                  vflag=False)
        self.evals += 1
        e = sum(energies.values())
        over = neigh.any_overflow if ctx.is_cellgrid else neigh.overflow
        e_h, fsq_h, over_h = self.read(torch.stack([
            e.double(), torch.sum(f * f).double(),
            torch.as_tensor(over, device=f.device).double()]))
        if over_h:
            raise RuntimeError(
                f"neighbor overflow during minimization (evaluation "
                f"{self.evals}): max_count={int(neigh.max_count)}, the "
                f"minimizer grows no capacity; cfg={ctx.neigh_cfg}")
        table = dict(s.peratom)
        carry = {k: table.pop(_KEY + k) for k in carry}
        return (s.replace(f=f, peratom=table or None), neigh, e, carry,
                (e_h, fsq_h))


def _converged(e, e_cur, etol, fsq, ftol) -> bool:
    """tpumd's stopping test: the energy change within etol of its size,
    or |f|^2 within ftol^2."""
    e_ok = etol > 0 and abs(e - e_cur) <= etol * 0.5 * (
        abs(e) + abs(e_cur) + 1e-30)
    return e_ok or (ftol > 0 and fsq <= ftol * ftol)


def _inv_mass(s, sim):
    return (1.0 / sim._ctx.mass_per_atom(s))[:, None]


def fire(sim, ev, s, neigh, etol, ftol, maxiter):
    """FIRE (tpumd/md/minimize.py:32-98): velocity Verlet kicks mixed
    toward the force, the step grown after delaystep downhill steps and
    halved (velocities zeroed) on an uphill one."""
    p = FIRE_PARAMS
    dt0 = sim._ctx.dt
    s, neigh, e, _, (e0, _) = ev(s, neigh, s.x)
    s = s.replace(v=torch.zeros_like(s.v))
    v = torch.zeros_like(s.x)
    dt = torch.tensor(dt0, dtype=s.x.dtype, device=s.x.device)
    alpha = torch.full_like(dt, p["alpha0"])
    nneg = torch.zeros((), dtype=torch.int32, device=s.x.device)
    e_cur, it, done = e0, 0, False
    while not done and it < maxiter:
        f = s.f
        v = v + dt * f * _inv_mass(s, sim)
        vdotf = torch.sum(v * f)
        fnorm = torch.sqrt(torch.sum(f * f))
        vnorm = torch.sqrt(torch.sum(v * v))
        mix = (1.0 - alpha) * v + alpha * f * (
            vnorm / torch.clamp(fnorm, min=1e-30))
        uphill = vdotf <= 0.0
        v = torch.where(uphill, torch.zeros_like(v), mix)
        grow = ~uphill & (nneg > p["delaystep"])
        dt = torch.where(grow, torch.clamp(dt * p["dt_grow"],
                                           max=p["tmax"] * dt0), dt)
        alpha = torch.where(grow, alpha * p["alpha_shrink"], alpha)
        dt = torch.where(uphill, dt * p["dt_shrink"], dt)
        alpha = torch.where(uphill, torch.full_like(alpha, p["alpha0"]),
                            alpha)
        nneg = torch.where(uphill, 0, nneg + 1)
        s, neigh, e, c, (e_h, fsq) = ev(s, neigh, s.x + dt * v, {"v": v})
        v = c["v"]
        it += 1
        done = _converged(e_h, e_cur, etol, fsq, ftol)
        e_cur = e_h
    return s, neigh, done, it, e0, e_cur


def linesearch_min(sim, ev, s, neigh, etol, ftol, maxiter, style):
    """cg or sd (tpumd/md/minimize.py:119-212): a search direction h (the
    force for sd; for cg f + beta h with tpumd's beta =
    max(0, (|f|^2 - |f_prev|^2) / |f_prev|^2), reset to f when uphill),
    then trials at alpha0 = min(1, dmax / max|h|) halved until the energy
    drops below e (1 + 1e-14), at most 20 halvings.  A search that finds
    no drop keeps the state and ends the minimization."""
    s, neigh, e, _, (e0, _) = ev(s, neigh, s.x)
    h = s.f
    gsq_prev = torch.sum(h * h)
    e_cur, it, done = e0, 0, False
    while not done and it < maxiter:
        f = s.f
        gsq = torch.sum(f * f)
        if style == "sd":
            h = f
        else:
            beta = torch.clamp((gsq - gsq_prev) / torch.clamp(
                gsq_prev, min=1e-300), min=0.0)
            hn = f + beta * h
            h = torch.where(torch.sum(hn * f) <= 0.0, f, hn)
        alpha = torch.clamp(DMAX / torch.clamp(torch.max(torch.abs(h)),
                                               min=1e-300), max=1.0)
        accept = False
        base = neigh
        for tries in range(21):
            if tries:
                alpha = alpha * 0.5
            st, nt, et, c, (e_h, fsq) = ev(s, base, s.x + alpha * h,
                                            {"h": h})
            if nt.xhold is base.xhold:
                # no re-bin: the next trial keeps the list's upkeep (a
                # refresh rebuilt it in place)
                base = nt.replace(ago=base.ago)
            if e_h < ev.lowered(e_cur + 1e-14 * abs(e_cur)):
                accept = True
                break
        it += 1
        gsq_prev = gsq
        if not accept:
            neigh = base
            done = True
            continue
        done = _converged(e_h, e_cur, etol, fsq, ftol)
        s, neigh, h, e_cur = st, nt, c["h"], e_h
    return s, neigh, done, it, e0, e_cur


def quickmin(sim, ev, s, neigh, etol, ftol, maxiter):
    """QuickMin (tpumd/md/minimize.py:215-285): v projected on f (zeroed
    when it points against f), an Euler step whose dt keeps every atom
    within dmax."""
    dt0, ftm2v = sim._ctx.dt, sim._ctx.units.ftm2v
    s, neigh, e, _, (e0, _) = ev(s, neigh, s.x)
    s = s.replace(v=torch.zeros_like(s.v))
    e_cur, it, done = e0, 0, False
    while not done and it < maxiter:
        v, f = s.v, s.f
        vdotf = torch.sum(v * f)
        fdotf = torch.sum(f * f)
        scale = torch.where(fdotf == 0.0, 0.0,
                            vdotf / torch.clamp(fdotf, min=1e-300))
        v = torch.where(vdotf < 0.0, torch.zeros_like(v), scale * f)
        dtv = torch.clamp(DMAX / torch.clamp(torch.max(torch.abs(v)),
                                             min=1e-300), max=dt0)
        x = s.x + dtv * v
        v = v + (dtv * ftm2v) * _inv_mass(s, sim) * f
        s, neigh, e, _, (e_h, fsq) = ev(s.replace(v=v), neigh, x)
        it += 1
        done = _converged(e_h, e_cur, etol, fsq, ftol)
        e_cur = e_h
    return s.replace(v=torch.zeros_like(s.v)), neigh, done, it, e0, e_cur


def hftn(sim, ev, s, neigh, etol, ftol, maxiter, maxeval):
    """Hessian-free truncated Newton (tpumd/md/minimize.py:288-477): an
    outer trust-region iteration around an inner CG solve of H p = f,
    H d from finite differences of forces (forward, central for a tiny
    gradient).  The iterates (xk, f, p, r, d) ride every evaluation."""
    V = {}

    def g(t) -> float:
        return ev.read(t)[0]

    def evaluate(x):
        nonlocal s, neigh
        s, neigh, e, c, (e_h, _) = ev(s, neigh, x, V)
        V.update(c)
        return s.f, e, e_h

    f, _, e_h = evaluate(s.x)
    e0 = e_cur = e_h
    V["f"] = f
    fnorm = math.sqrt(g(torch.sum(f * f)))
    nunk = 3 * sim.natoms
    tr_max = DMAX * math.sqrt(nunk)
    tr = min(1.5 * fnorm, tr_max)
    last_newton = tr_max
    xinf = g(torch.max(torch.abs(s.x)))

    def dirder(d_key, fwd):
        """H d by finite differences of the forces at xk."""
        dn = math.sqrt(g(torch.sum(V[d_key] ** 2)))
        if dn == 0.0:
            return torch.zeros_like(V[d_key])
        if fwd:
            eps = 2.0 * math.sqrt(1000.0 * MEPS) / dn
            f1, _, _ = evaluate(V["xk"] + eps * V[d_key])
            return (V["f"] - f1) / eps
        eps = (3000.0 * MEPS) ** (1.0 / 3.0) / dn
        f1, _, _ = evaluate(V["xk"] + eps * V[d_key])
        V["f1"] = f1
        f2, _, _ = evaluate(V["xk"] - eps * V[d_key])
        return (f2 - V.pop("f1")) / (2.0 * eps)

    def dot(a, b) -> float:
        return g(torch.sum(V[a] * V[b]))

    converged = False
    it = 0
    for it in range(1, maxiter + 1):
        if fnorm < ftol:
            converged = True
            break
        if ev.evals >= maxeval:
            break
        V["xk"] = s.x
        cg_tol = max(min(fnorm / 2.0, 0.1 / it), ftol)
        V["p"] = torch.zeros_like(s.x)
        V["r"] = V["f"]
        V["d"] = V["f"]
        rr = fnorm * fnorm
        r0norm = fnorm
        pp = 0.0
        nlim = nunk // 5
        if nlim < 100:
            nlim = min(nunk, 100)
        nlim = min(nlim, max((maxeval - ev.evals) // 2, 1))
        if fnorm < math.sqrt(MEPS) * max(1.0, abs(e_cur)):
            nlim = min(nlim, max(nunk // 20, 1))
        fwd = fnorm > 1000.0 * math.sqrt(MEPS)
        step_type = "iters"
        for _ in range(nlim):
            V["hd"] = dirder("d", fwd)
            dhd, dd = dot("d", "hd"), dot("d", "d")
            if dhd <= MEPS * dd:
                # negative curvature: to the trust region's edge along d,
                # the root with the larger model reduction
                pd, phd = dot("p", "d"), dot("p", "hd")
                gd = -dot("f", "d")
                disc = max(pd * pd - dd * (pp - tr * tr), 0.0) ** 0.5
                roots = [(-pd + disc) / dd, (-pd - disc) / dd]
                red = [t * (gd + phd) + 0.5 * t * t * dhd for t in roots]
                tau = roots[0] if -red[0] > -red[1] else roots[1]
                V["p"] = V["p"] + tau * V["d"]
                step_type = "negcurv"
                break
            alpha = rr / dhd
            V["p_old"] = V["p"]
            V["p"] = V["p"] + alpha * V["d"]
            ppnew = dot("p", "p")
            if math.sqrt(ppnew) > tr:
                # crossed the trust region: back to its edge
                pd = dot("p_old", "d")
                disc = max(pd * pd - dd * (pp - tr * tr), 0.0) ** 0.5
                V["p"] = V["p_old"] + ((-pd + disc) / dd) * V["d"]
                step_type = "tr"
                break
            if g(torch.max(torch.abs(V["p"]))) > DMAX:
                V["p"] = V["p_old"]
                step_type = "dmax"
                break
            V["r"] = V["r"] - alpha * V["hd"]
            rrnew = dot("r", "r")
            if math.sqrt(rrnew) < cg_tol * r0norm:
                step_type = "newton"
                break
            V["d"] = V["r"] + (rrnew / rr) * V["d"]
            rr = rrnew
            pp = ppnew
        slen2 = math.sqrt(dot("p", "p"))
        sleninf = g(torch.max(torch.abs(V["p"])))
        V["hp"] = dirder("p", fwd)
        gdotp = -dot("f", "p")
        f_new, _, e_new = evaluate(V["xk"] + V["p"])
        V["f_new"] = f_new
        f2new = math.sqrt(g(torch.sum(f_new * f_new)))
        ared = e_cur - e_new
        if f2new < ftol:
            e_cur, fnorm = e_new, f2new
            converged = True
            break
        if step_type != "dmax":
            mag = max(0.5 * (abs(e_cur) + abs(e_new)), MIN_ETOL_MAG)
            if abs(ared) < etol * mag or sleninf == 0.0:
                e_cur, fnorm = e_new, f2new
                converged = True
                break
        pred = -gdotp - 0.5 * dot("p", "hp")
        if ared > 0.0 and (f2new < fnorm or fnorm > 1.0e-6):
            e_cur = e_new
            V["f"] = V["f_new"]
            fnorm = f2new
            if step_type == "newton":
                last_newton = slen2
            if ared > 0.75 * pred and slen2 >= 0.99 * tr:
                tr = 2.0 * tr
            tr = min(tr, tr_max)
            if step_type == "dmax":
                tr = 0.1 * tr if slen2 <= MEPS else min(tr, 2.0 * slen2)
        else:
            # rejected: back to xk
            V["f"], _, e_cur = evaluate(V["xk"])
            fnorm = math.sqrt(g(torch.sum(V["f"] ** 2)))
            if step_type == "negcurv" and -ared > pred:
                tr = 0.10 * min(tr, slen2)
            elif step_type == "dmax" and slen2 <= MEPS:
                tr = 0.10 * tr
            elif -ared > pred:
                tr = 0.20 * min(tr, slen2)
            else:
                tr = 0.25 * min(tr, slen2)
            if step_type != "newton" and fnorm < math.sqrt(MEPS):
                tr = min(tr, 2.0 * last_newton)
            last_newton = tr_max
            if tr <= 0.0 or tr <= MEPS * max(1.0, xinf):
                break
    return s, neigh, converged, it, e0, e_cur


STYLES = ("fire", "cg", "sd", "quickmin", "hftn")


def minimize(sim, style: str, etol: float, ftol: float, maxiter: int,
             maxeval: int):
    """Run one minimization from the simulation's set-up state; returns
    (converged, iterations, e0, e_final) and leaves the state, its
    energies and ``sim.min_stats`` (iterations, force evaluations, host
    reads, re-bins, wall seconds)."""
    if style not in STYLES:
        raise NotImplementedError(f"min_style {style} is not ported "
                                  f"({', '.join(STYLES)})")
    s, neigh, fstates = sim._carry
    ev = Evaluator(sim)
    t0 = time.perf_counter()
    if style == "fire":
        out = fire(sim, ev, s, neigh, etol, ftol, maxiter)
    elif style in ("cg", "sd"):
        out = linesearch_min(sim, ev, s, neigh, etol, ftol, maxiter, style)
    elif style == "quickmin":
        out = quickmin(sim, ev, s, neigh, etol, ftol, maxiter)
    else:
        out = hftn(sim, ev, s, neigh, etol, ftol, maxiter, maxeval)
    s, neigh, done, it, e0, e1 = out
    # the thermo row after: one more evaluation, with the virial
    f, energies, virial, _, neigh = compute_forces(s, neigh, sim._ctx,
                                                   eflag=True, vflag=True)
    ev.evals += 1
    sim._carry = (s, neigh, fstates)
    sim.state = s
    sim._last_energies, sim._last_virial = energies, virial
    sim._energies_of = s
    if s.x.device.type == "cuda":
        torch.cuda.synchronize(s.x.device)
    sim.min_stats = {"style": style, "iterations": it,
                     "evaluations": ev.evals, "reads": ev.reads,
                     "rebins": ev.rebins,
                     "seconds": time.perf_counter() - t0}
    return bool(done), it, e0, e1
