"""fix nvt / npt: Nose-Hoover thermostat chain and MTK barostat.

PyTorch counterpart of tpumd/md/fix_nh.py (the reference's FixNH,
src/fix_nh.cpp) for orthogonal boxes, all atoms: the chain integrator
(nhc_temp_integrate, :1758), the barostat update (nh_omega_dot, :2247),
the velocity scaling (nh_v_press) and the half-step box remap with
x -> lamda -> x dilation about the box centre (remap, :1086-1240), in the
operation order of initial_integrate/final_integrate (:829-925), with the
temperature target ramped from start to stop over the run.

The barostat reads the pressure during integration, from the previous
force evaluation's virial: the step loop hands each step's total virial to
the fix (``needs_virial``, ``save_virial``), and writes the timestep into
the fix state for the ramp (``needs_step``).  Every quantity stays on the
device, so the fix reads nothing back.

Ported keywords: temp, x/y/z (a barostat on those axes), tchain, pchain 0,
mtk no.  Others (iso, aniso, tri, tilt factors, mtk yes, pchain > 0,
drag, tloop, ploop) raise.
"""

from __future__ import annotations

import dataclasses

import torch

from tpumd_torch.md import computes
from tpumd_torch.md.fixes import Fix


@dataclasses.dataclass(frozen=True)
class NHState:
    eta: torch.Tensor          # (tchain,)
    eta_dot: torch.Tensor      # (tchain + 1,): a trailing 0
    eta_dotdot: torch.Tensor   # (tchain,)
    omega: torch.Tensor        # (3,)
    omega_dot: torch.Tensor    # (3,)
    virial: torch.Tensor       # (6,) of the last force evaluation
    t_target: torch.Tensor     # () the ramped temperature target
    step: int                  # the timestep (host schedule)
    begin: int                 # the run's first and last steps
    end: int

    def replace(self, **kw) -> "NHState":
        return dataclasses.replace(self, **kw)


class FixNH(Fix):
    name = "nh"
    needs_virial = True
    needs_step = True

    def __init__(self, t_start, t_stop, t_period, p_flags=(False,) * 3,
                 p_start=(0.0,) * 3, p_stop=(0.0,) * 3, p_period=(0.0,) * 3,
                 tchain=3):
        self.t_start = float(t_start)
        self.t_stop = float(t_stop)
        self.t_period = float(t_period)
        self.p_flags = tuple(bool(p) for p in p_flags)
        self.pstat = any(self.p_flags)
        self.box_change = self.pstat
        self.p_start = tuple(float(p) for p in p_start)
        self.p_stop = tuple(float(p) for p in p_stop)
        self.p_period = tuple(float(p) for p in p_period)
        self.mtchain = int(tchain)
        self.pdim = sum(self.p_flags)
        self._flags = {}

    def _axes(self, like):
        """The barostat's axis flags on like's device, made once: a host
        copy every step would wait for the card."""
        t = self._flags.get(like.device)
        if t is None:
            t = self._flags[like.device] = torch.tensor(self.p_flags,
                                                        device=like.device)
        return t

    @classmethod
    def parse(cls, style, args):
        """fix ID group nvt|npt temp Tstart Tstop Tdamp [x|y|z Pstart
        Pstop Pdamp] [tchain N] [pchain 0] [mtk no]."""
        kw = {}
        p_flags, p_start = [False] * 3, [0.0] * 3
        p_stop, p_period = [0.0] * 3, [0.0] * 3
        i = 0
        while i < len(args):
            key = args[i]
            if key == "temp":
                kw.update(t_start=float(args[i + 1]),
                          t_stop=float(args[i + 2]),
                          t_period=float(args[i + 3]))
                i += 4
            elif key in ("x", "y", "z"):
                d = "xyz".index(key)
                p_flags[d] = True
                p_start[d], p_stop[d], p_period[d] = (
                    float(v) for v in args[i + 1:i + 4])
                i += 4
            elif key == "tchain":
                kw["tchain"] = int(args[i + 1])
                i += 2
            elif (key, args[i + 1] if i + 1 < len(args) else None) in (
                    ("pchain", "0"), ("mtk", "no")):
                i += 2
            else:
                raise NotImplementedError(
                    f"fix {style} keyword {key!r} is not ported (ported: "
                    "temp, x, y, z, tchain, pchain 0, mtk no)")
        if "t_start" not in kw:
            raise NotImplementedError(f"fix {style} without temp (nph) is "
                                      "not ported")
        if (style == "npt") != any(p_flags):
            raise NotImplementedError(
                f"fix {style} with barostat axes {p_flags}: nvt takes none, "
                "npt at least one of x y z")
        if any(p_flags) and not ("pchain", "0") in zip(args, args[1:]):
            raise NotImplementedError(
                "fix npt: the barostat thermostat chain (pchain > 0) is not "
                "ported; give pchain 0")
        if any(p_flags) and not ("mtk", "no") in zip(args, args[1:]):
            raise NotImplementedError(
                "fix npt: the MTK correction terms (mtk yes) are not "
                "ported; give mtk no")
        return cls(p_flags=p_flags, p_start=p_start, p_stop=p_stop,
                   p_period=p_period, **kw)

    # -------------------------------------------------------------- state
    def init_state(self, s, ctx):
        mt = self.mtchain
        dev, dt_ = s.x.device, s.x.dtype

        def vec(vals):
            return torch.tensor(vals, dtype=dt_, device=dev)
        # FixNH::setup: the upper-chain accelerations from zero chain
        # velocities, eta_dotdot[i>0] = -kT / eta_mass[i] = -t_freq^2
        tf2 = (1.0 / self.t_period) ** 2
        return NHState(
            eta=vec([0.0] * mt), eta_dot=vec([0.0] * (mt + 1)),
            eta_dotdot=vec([0.0] + [-tf2] * (mt - 1)),
            omega=vec([0.0] * 3), omega_dot=vec([0.0] * 3),
            virial=vec([0.0] * 6), t_target=vec(self.t_start),
            step=0, begin=0, end=0)

    def save_virial(self, fstate, virial):
        return fstate.replace(virial=virial)

    def set_step(self, fstate, istep):
        return fstate.replace(step=istep)

    def pre_run(self, fstate, begin: int, end: int):
        return fstate.replace(begin=begin, end=end)

    # ------------------------------------------------------------ helpers
    def _temp_target(self, fst):
        """compute_temp_target: start + delta (stop - start)."""
        den = fst.end - fst.begin
        delta = (fst.step - fst.begin) / den if den > 0 else 0.0
        return self.t_start + delta * (self.t_stop - self.t_start)

    def _p_hydro(self, fst):
        """compute_press_target: the mean ramped target of the barostat
        axes."""
        den = fst.end - fst.begin
        delta = (fst.step - fst.begin) / den if den > 0 else 0.0
        hydro = 0.0
        for i in range(3):
            if self.p_flags[i]:
                hydro += self.p_start[i] + delta * (self.p_stop[i]
                                                    - self.p_start[i])
        return hydro / self.pdim

    def _t_current(self, s, ctx):
        u = ctx.units
        return computes.temperature(s.v, ctx.mass_per_atom(s), ctx.tdof,
                                    u.boltz, u.mvv2e)

    def _p_current(self, s, ctx, virial):
        """Pressure per axis (compute_pressure::compute_vector): the
        kinetic tensor's diagonal plus the virial's, over the volume."""
        m = ctx.mass_per_atom(s)
        mvv = ctx.units.mvv2e * torch.sum(m[:, None] * s.v * s.v, dim=0)
        return computes.pressure_vector(mvv, virial, s.box.volume,
                                        ctx.units.nktv2p)

    def _nhc_temp(self, s, fst, ctx, t_current):
        """nhc_temp_integrate: half a step of the thermostat chain; scales
        the velocities.  Returns (state, fix state, T after scaling)."""
        u = ctx.units
        boltz, dt = u.boltz, ctx.dt
        dthalf, dt4, dt8 = 0.5 * dt, 0.25 * dt, 0.125 * dt
        tdof = ctx.tdof
        t_target = fst.t_target
        ke_target = tdof * boltz * t_target
        t_freq = 1.0 / self.t_period
        mt = self.mtchain
        eta_mass0 = tdof * boltz * t_target / (t_freq * t_freq)
        eta_massk = boltz * t_target / (t_freq * t_freq)
        eta = fst.eta
        ed = list(fst.eta_dot.unbind())
        edd = list(fst.eta_dotdot.unbind())

        kecurrent = tdof * boltz * t_current
        edd[0] = (kecurrent - ke_target) / eta_mass0
        for ich in range(mt - 1, 0, -1):
            expfac = torch.exp(-dt8 * ed[ich + 1])
            ed[ich] = (ed[ich] * expfac + edd[ich] * dt4) * expfac
        expfac = torch.exp(-dt8 * ed[1])
        ed[0] = (ed[0] * expfac + edd[0] * dt4) * expfac
        factor_eta = torch.exp(-dthalf * ed[0])
        t_current = t_current * factor_eta * factor_eta
        kecurrent = tdof * boltz * t_current
        edd[0] = (kecurrent - ke_target) / eta_mass0
        eta = eta + dthalf * torch.stack(ed[:mt])
        ed[0] = (ed[0] * expfac + edd[0] * dt4) * expfac
        for ich in range(1, mt):
            expfac = torch.exp(-dt8 * ed[ich + 1])
            mass_prev = eta_mass0 if ich == 1 else eta_massk
            edd[ich] = (mass_prev * ed[ich - 1] ** 2
                        - boltz * t_target) / eta_massk
            ed[ich] = (ed[ich] * expfac + edd[ich] * dt4) * expfac
        fst = fst.replace(eta=eta, eta_dot=torch.stack(ed),
                          eta_dotdot=torch.stack(edd))
        return s.replace(v=s.v * factor_eta), fst, t_current

    def _omega_dot_update(self, s, fst, ctx, p_current):
        """nh_omega_dot without the MTK terms: the barostat velocity of
        each coupled axis."""
        dthalf = 0.5 * ctx.dt
        nkt = (ctx.natoms + 1) * ctx.units.boltz * fst.t_target
        p_hydro = self._p_hydro(fst)
        od = list(fst.omega_dot.unbind())
        for i in range(3):
            if self.p_flags[i]:
                p_freq = 1.0 / self.p_period[i]
                omega_mass = nkt / (p_freq * p_freq)
                f_omega = ((p_current[i] - p_hydro) * s.box.volume
                           / (omega_mass * ctx.units.nktv2p))
                od[i] = od[i] + f_omega * dthalf
        return fst.replace(omega_dot=torch.stack(od))

    def _v_press(self, s, fst, ctx):
        """nh_v_press: v *= exp(-dt/4 omega_dot)^2 on the coupled axes."""
        fac = torch.where(self._axes(s.x),
                          torch.exp(-0.25 * ctx.dt * fst.omega_dot), 1.0)
        return s.replace(v=s.v * (fac * fac)[None, :])

    def _remap(self, s, fst, ctx):
        """Half-step box dilation about the centre; positions follow in
        lamda coordinates."""
        dto = 0.5 * ctx.dt
        box = s.box
        lam = (s.x - box.lo) / box.lengths
        flags = self._axes(s.x)
        expfac = torch.exp(dto * fst.omega_dot)
        center = 0.5 * (box.lo + box.hi)
        lo = torch.where(flags, (box.lo - center) * expfac + center, box.lo)
        hi = torch.where(flags, (box.hi - center) * expfac + center, box.hi)
        new_box = box.replace(lo=lo, hi=hi)
        return (s.replace(x=lo + lam * (hi - lo), box=new_box),
                fst.replace(omega=fst.omega + dto * fst.omega_dot))

    # ------------------------------------------------------------- hooks
    def initial_integrate(self, s, fst, ctx):
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        t_current = self._t_current(s, ctx)
        fst = fst.replace(t_target=torch.full_like(
            fst.t_target, self._temp_target(fst)))
        s, fst, t_current = self._nhc_temp(s, fst, ctx, t_current)
        if self.pstat:
            p_current = self._p_current(s, ctx, fst.virial)
            fst = self._omega_dot_update(s, fst, ctx, p_current)
            s = self._v_press(s, fst, ctx)
        s = s.replace(v=torch.addcmul(s.v, (dtf / ctx.mass_per_atom(s))[
            :, None], s.f))
        if self.pstat:
            s, fst = self._remap(s, fst, ctx)
        s = s.replace(x=s.x + ctx.dt * s.v)
        if self.pstat:
            s, fst = self._remap(s, fst, ctx)
        return s, fst

    def final_integrate(self, s, fst, ctx):
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        s = s.replace(v=torch.addcmul(s.v, (dtf / ctx.mass_per_atom(s))[
            :, None], s.f))
        if self.pstat:
            s = self._v_press(s, fst, ctx)
        t_current = self._t_current(s, ctx)
        if self.pstat:
            p_current = self._p_current(s, ctx, fst.virial)
            fst = self._omega_dot_update(s, fst, ctx, p_current)
        s, fst, _ = self._nhc_temp(s, fst, ctx, t_current)
        return s, fst


def make_nvt(t_start, t_stop, t_period, tchain=3):
    return FixNH(t_start, t_stop, t_period, tchain=tchain)


def make_npt_z(t_start, t_stop, t_period, p_start, p_stop, p_period,
               tchain=3):
    """npt coupled along z only (the rhodo_class deck's barostat)."""
    return FixNH(t_start, t_stop, t_period, p_flags=(False, False, True),
                 p_start=(0.0, 0.0, p_start), p_stop=(0.0, 0.0, p_stop),
                 p_period=(0.0, 0.0, p_period), tchain=tchain)
