"""fix nvt / npt / nph: Nose-Hoover thermostat chains and the MTK barostat.

PyTorch counterpart of tpumd/md/fix_nh.py (the reference's FixNH,
src/fix_nh.cpp), on the fix's group (its temperature over its own dof;
the box remap moves every atom, as LAMMPS's dilate all): the chain
integrators nhc_temp_integrate (:1758) and nhc_press_integrate (:1829),
the barostat update nh_omega_dot (:2247) with the MTK terms, the
velocity scaling nh_v_press with the tilt couplings of a triclinic
barostat (:1955-1963), and the half-step box remap (:1086-1240): x ->
lamda -> x dilation about the box centre, the tilt factors'
time-symmetric updates around it where they are barostatted, scaled
with the cell where they are not. The operation order is that of
initial_integrate/final_integrate (:829-925), with the temperature and
pressure targets ramped from start to stop over the run.

Coupling: iso (the mean of the three diagonal pressures), aniso, x/y/z,
xy/xz/yz and tri (aniso plus the three tilts at zero target).  The
barostat reads the pressure during integration, from the previous force
evaluation's virial: the step loop hands each step's total virial to the
fix (``needs_virial``, ``save_virial``) and writes the timestep into the
fix state for the ramps (``needs_step``).  Every quantity stays on the
device, so the fix reads nothing back after its set-up.

Across ranks (``StepContext.decomp``, parallel/decomp.py) each rank sums
the atoms it owns (not a local grid's halo copies), and the sums that a
call site reads, the kinetic energy and tensor, go over the process group
in one float64 all-reduce (``Mesh.sum_packed``); the step loop hands the
fix the virial already summed over the ranks.  The chain's and the
barostat's scalars are replicated, so every rank computes the same box;
the remap dilates every local slot, halos included, and the next position
exchange refreshes the halos from their owners.

Keywords: temp, iso, aniso, x, y, z, xy, xz, yz, tri, tchain, pchain,
mtk, drag (defaults tchain 3, pchain 3, mtk yes).  tloop, ploop, nreset,
scalexy/scaleyz/scalexz and fixedpoint are taken only at LAMMPS's default
(tloop 1, ploop 1, nreset 0, scale* yes, fixedpoint at the box centre);
any other value, and any other keyword, raises, naming the keyword.
nph has no temp: it targets the set-up's temperature t0 (:746-752).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpumd_torch.md.fixes import Fix

# the six barostat components in the reference's omega order (couple()'s
# Voigt reorder): x, y, z, yz, xz, xy
_PKEYS = ("x", "y", "z", "yz", "xz", "xy")
# the keywords tpumd takes without acting on them, each at the one value
# the port takes (LAMMPS's default)
_DEFAULT_ONLY = {"tloop": "1", "ploop": "1", "nreset": "0",
                 "scalexy": "yes", "scaleyz": "yes", "scalexz": "yes"}


@dataclasses.dataclass(frozen=True)
class NHState:
    eta: torch.Tensor          # (tchain,)
    eta_dot: torch.Tensor      # (tchain + 1,): a trailing 0
    eta_dotdot: torch.Tensor   # (tchain,)
    etap: torch.Tensor         # (max(pchain, 1),)
    etap_dot: torch.Tensor     # (max(pchain, 1) + 1,): a trailing 0
    etap_dotdot: torch.Tensor  # (max(pchain, 1),)
    omega: torch.Tensor        # (6,) in omega order
    omega_dot: torch.Tensor    # (6,)
    virial: torch.Tensor       # (6,) Voigt, of the last force evaluation
    t_target: torch.Tensor     # () the ramped temperature target
    t0: torch.Tensor           # () the set-up's temperature (nph's target)
    step: int                  # the timestep (host schedule)
    begin: int                 # the run's first and last steps
    end: int

    def replace(self, **kw) -> "NHState":
        return dataclasses.replace(self, **kw)


class FixNH(Fix):
    name = "nh"
    # on a group other than all: its dof, dimension (n - 1), which the
    # set-up counts (tpumd/md/simulation.py:459-464)
    group_tdof = None
    needs_step = True

    def __init__(self, t_start=None, t_stop=None, t_period=None,
                 p_flags=None, p_start=None, p_stop=None, p_period=None,
                 tchain=3, pchain=3, mtk=True, couple_iso=False, drag=0.0,
                 fixedpoint=None):
        self.tstat = t_start is not None
        self.t_start = None if t_start is None else float(t_start)
        self.t_stop = (self.t_start if t_stop is None else float(t_stop))
        self.t_period = None if t_period is None else float(t_period)

        def six(vals):
            vals = [float(v) for v in (vals or ())]
            return tuple(vals + [0.0] * (6 - len(vals)))
        pf = [bool(p) for p in (p_flags or ())]
        self.p_flags = tuple(pf + [False] * (6 - len(pf)))
        self.p_start, self.p_stop = six(p_start), six(p_stop)
        self.p_period = six(p_period)
        self.pstat = any(self.p_flags)
        self.box_change = self.pstat
        # the barostat reads the step's virial; a thermostat alone does not
        self.needs_virial = self.pstat
        self.tri = any(self.p_flags[3:])
        self.mtchain = int(tchain)
        self.mpchain = int(pchain) if self.pstat else 0
        self.mtk = bool(mtk) and self.pstat
        self.iso = bool(couple_iso)
        self.drag = float(drag)
        self.pdim = sum(self.p_flags[:3])
        self.p_freq_max = (max(1.0 / self.p_period[i] for i in range(6)
                               if self.p_flags[i]) if self.pstat else 0.0)
        self.fixedpoint = (None if fixedpoint is None
                           else tuple(float(v) for v in fixedpoint))
        # set at init_state: the drag factors at the run's dt and the
        # tilt factors that scale with the cell
        self.tdrag_factor = self.pdrag_factor = 1.0
        self.scalexy = self.scalexz = self.scaleyz = False
        self._flags = {}

    @classmethod
    def parse(cls, style, args):
        """fix ID group nvt|npt|nph [temp Tstart Tstop Tdamp] [iso|aniso|tri
        Pstart Pstop Pdamp] [x|y|z|xy|xz|yz Pstart Pstop Pdamp] [tchain N]
        [pchain N] [mtk yes|no] [drag D], and tloop, ploop, nreset,
        scale* and fixedpoint at their defaults (tpumd/script/parser.py:
        1805-1862)."""
        kw = {}
        flags, start = [False] * 6, [0.0] * 6
        stop, period = [0.0] * 6, [0.0] * 6
        i = 0

        def value(n=1):
            if i + n >= len(args):
                raise ValueError(f"fix {style} {args[i]}: expected {n} "
                                 "value(s)")
            return args[i + 1:i + 1 + n]
        while i < len(args):
            key = args[i]
            if key == "temp":
                kw.update(zip(("t_start", "t_stop", "t_period"),
                              (float(v) for v in value(3))))
                i += 4
            elif key in ("iso", "aniso", "tri"):
                p0, p1, pp = (float(v) for v in value(3))
                # tri: aniso on the diagonal and the tilts at a zero target
                # (fix_nh.cpp:169-181)
                for d in range(6 if key == "tri" else 3):
                    flags[d] = True
                    start[d] = p0 if d < 3 else 0.0
                    stop[d] = p1 if d < 3 else 0.0
                    period[d] = pp
                kw["couple_iso"] = key == "iso"
                i += 4
            elif key in _PKEYS:
                d = _PKEYS.index(key)
                flags[d] = True
                start[d], stop[d], period[d] = (
                    float(v) for v in value(3))
                i += 4
            elif key in ("tchain", "pchain"):
                kw[key] = int(value()[0])
                i += 2
            elif key == "mtk":
                v = value()[0]
                if v not in ("yes", "no"):
                    raise ValueError(f"fix {style} mtk {v!r}: yes or no")
                kw["mtk"] = v == "yes"
                i += 2
            elif key == "drag":
                kw["drag"] = float(value()[0])
                i += 2
            elif key in _DEFAULT_ONLY:
                if value()[0] != _DEFAULT_ONLY[key]:
                    raise NotImplementedError(
                        f"fix {style} {key} {args[i + 1]}: the port takes "
                        f"{key} only at its default {_DEFAULT_ONLY[key]} "
                        "(ROADMAP C12)")
                i += 2
            elif key == "fixedpoint":
                kw["fixedpoint"] = [float(v) for v in value(3)]
                i += 4
            else:
                raise NotImplementedError(
                    f"fix {style} keyword {key!r} is not ported (ported: "
                    "temp, iso, aniso, tri, x, y, z, xy, xz, yz, tchain, "
                    "pchain, mtk, drag; tloop, ploop, nreset, scale* and "
                    "fixedpoint at their defaults)")
        if style == "nph" and "t_start" in kw:
            raise ValueError("fix nph does not take temp")
        if style in ("nvt", "npt") and "t_start" not in kw:
            raise ValueError(f"fix {style} needs the temp keyword")
        if style == "nvt" and any(flags):
            raise ValueError("fix nvt takes no barostat keyword")
        if style in ("npt", "nph") and not any(flags):
            raise ValueError(f"fix {style} needs a barostat keyword")
        return cls(p_flags=flags if any(flags) else None, p_start=start,
                   p_stop=stop, p_period=period, **kw)

    def _axes(self, like):
        """The diagonal barostat flags on like's device, made once: a host
        copy every step would wait for the card."""
        t = self._flags.get(like.device)
        if t is None:
            t = self._flags[like.device] = torch.tensor(self.p_flags[:3],
                                                        device=like.device)
        return t

    # -------------------------------------------------------------- state
    def init_state(self, s, ctx):
        box = s.box
        if self.tri and not box.istriclinic:
            # FixNH::init: "Can not specify Pxy/Pxz/Pyz in fix npt/nph with
            # non-triclinic box"
            raise ValueError("Can not specify Pxy/Pxz/Pyz in fix npt/nph "
                             "with non-triclinic box")
        if self.fixedpoint is not None:
            lo = box.lo.detach().cpu().numpy().astype(np.float64)
            hi = box.hi.detach().cpu().numpy().astype(np.float64)
            if not np.allclose(self.fixedpoint, 0.5 * (lo + hi), rtol=0.0,
                               atol=1e-9 * max(1.0, float((hi - lo).max()))):
                raise NotImplementedError(
                    f"fix nh fixedpoint {self.fixedpoint}: the port dilates "
                    f"about the box centre {tuple(0.5 * (lo + hi))} only "
                    "(ROADMAP C12)")
        if box.istriclinic:
            tilt = box.tilt.detach().cpu().numpy().astype(np.float64)
            per = box.periodic
            self.scalexy = bool(per[1] and tilt[0] != 0.0
                                and not self.p_flags[5])
            self.scalexz = bool(per[2] and tilt[1] != 0.0
                                and not self.p_flags[4])
            self.scaleyz = bool(per[2] and tilt[2] != 0.0
                                and not self.p_flags[3])
        # the drag factors at the run's dt (FixNH ctor, tloop = ploop = 1)
        self.tdrag_factor = (1.0 - self.drag * (1.0 / self.t_period) * ctx.dt
                             if self.drag and self.tstat else 1.0)
        self.pdrag_factor = (1.0 - self.drag * self.p_freq_max * ctx.dt
                             if self.drag and self.pstat else 1.0)
        mt, mp = self.mtchain, max(self.mpchain, 1)
        dev, dt_ = s.x.device, s.x.dtype

        def zeros(n):
            return torch.zeros(n, dtype=dt_, device=dev)
        # FixNH::setup: the upper-chain accelerations from zero chain
        # velocities, eta_dotdot[i>0] = -kT / eta_mass[i] = -t_freq^2
        edd = zeros(mt)
        if self.tstat and mt > 1:
            edd[1:] = -(1.0 / self.t_period) ** 2
        t0 = self._t_current(s, ctx).to(dt_)
        return NHState(
            eta=zeros(mt), eta_dot=zeros(mt + 1), eta_dotdot=edd,
            etap=zeros(mp), etap_dot=zeros(mp + 1), etap_dotdot=zeros(mp),
            omega=zeros(6), omega_dot=zeros(6), virial=zeros(6),
            # nph targets t0 (fix_nh.cpp:746-752)
            t_target=(torch.full((), self.t_start, dtype=dt_, device=dev)
                      if self.tstat else t0),
            t0=t0, step=0, begin=0, end=0)

    def save_virial(self, fstate, virial):
        return fstate.replace(virial=virial)

    def set_step(self, fstate, istep):
        return fstate.replace(step=istep)

    def pre_run(self, fstate, begin: int, end: int):
        return fstate.replace(begin=begin, end=end)

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _delta(fst) -> float:
        """(ntimestep - beginstep) / (endstep - beginstep), 0 at begin."""
        den = fst.end - fst.begin
        return (fst.step - fst.begin) / den if den > 0 else 0.0

    def _temp_target(self, fst) -> float:
        """compute_temp_target: start + delta (stop - start)."""
        return self.t_start + self._delta(fst) * (self.t_stop - self.t_start)

    def _p_hydro(self, fst) -> float:
        """compute_press_target's hydrostatic part: the mean ramped target
        of the barostatted diagonal."""
        delta = self._delta(fst)
        hydro = sum(self.p_start[i] + delta * (self.p_stop[i]
                                               - self.p_start[i])
                    for i in range(3) if self.p_flags[i])
        return hydro / self.pdim if self.pdim else 0.0

    def _tdof(self, ctx):
        return ctx.tdof if self.group_tdof is None else self.group_tdof

    def _gv(self, s, ctx):
        """The velocities of the fix's group, 0 elsewhere (and, on a
        rank's local grid, 0 in the slots it does not own)."""
        v = self.in_group(s, s.v, torch.zeros_like(s.v))
        own = None if ctx.decomp is None else ctx.decomp.owned_atoms(s)
        return v if own is None else torch.where(own[:, None], v, 0.0)

    def _kinetic(self, s, ctx, temp: bool, tensor: bool):
        """The sums over the group's atoms that a call site reads: where
        temp, the temperature (compute temp); where tensor, the kinetic
        tensor mvv2e sum m v_a v_b, its diagonal (3,) and for tri its yz,
        xz, xy terms (3,); the rest None.  Across ranks one all-reduce
        adds the ranks' sums."""
        m = ctx.mass_per_atom(s)
        v = self._gv(s, ctx)
        u = ctx.units
        ke2 = mvv = od = None
        if temp:
            ke2 = torch.sum(m[:, None] * v * v)
        if tensor:
            mvv = u.mvv2e * torch.sum(m[:, None] * v * v, dim=0)
            if self.tri:
                od = u.mvv2e * torch.stack([
                    torch.sum(m * v[:, 1] * v[:, 2]),
                    torch.sum(m * v[:, 0] * v[:, 2]),
                    torch.sum(m * v[:, 0] * v[:, 1])])
        if ctx.decomp is not None:
            ke2, mvv, od = ctx.decomp.mesh.sum_packed(ke2, mvv, od)
        t = None if ke2 is None else ke2 * (
            u.mvv2e / (self._tdof(ctx) * u.boltz))
        return t, mvv, od

    def _t_current(self, s, ctx):
        return self._kinetic(s, ctx, True, False)[0]

    def _p_current(self, s, ctx, virial, mvv, od):
        """Pressure components (compute_pressure::compute_vector) in omega
        order: (x, y, z[, yz, xz, xy]), each the kinetic tensor's (mvv, od
        of ``_kinetic``) plus the virial's over the volume; iso couples
        the diagonal to its mean.  virial is Voigt (xx yy zz xy xz yz)."""
        scale = ctx.units.nktv2p / s.box.volume
        p = (mvv + virial[:3]) * scale
        if self.iso:
            p = (torch.sum(p) / 3.0).expand(3)
        if not self.tri:
            return p
        return torch.cat([p, (od + virial[[5, 4, 3]]) * scale])

    def _nhc_temp(self, s, fst, ctx, t_current):
        """nhc_temp_integrate: half a step of the thermostat chain; scales
        the velocities.  Returns (state, fix state, T after scaling)."""
        boltz, dt = ctx.units.boltz, ctx.dt
        dthalf, dt4, dt8 = 0.5 * dt, 0.25 * dt, 0.125 * dt
        tdof = self._tdof(ctx)
        t_target = fst.t_target
        ke_target = tdof * boltz * t_target
        t_freq = 1.0 / self.t_period
        mt = self.mtchain
        tdrag = self.tdrag_factor
        eta_mass0 = tdof * boltz * t_target / (t_freq * t_freq)
        eta_massk = boltz * t_target / (t_freq * t_freq)
        ed = list(fst.eta_dot.unbind())
        edd = list(fst.eta_dotdot.unbind())

        edd[0] = (tdof * boltz * t_current - ke_target) / eta_mass0
        for ich in range(mt - 1, 0, -1):
            expfac = torch.exp(-dt8 * ed[ich + 1])
            ed[ich] = (ed[ich] * expfac + edd[ich] * dt4) * tdrag * expfac
        expfac = torch.exp(-dt8 * ed[1])
        ed[0] = (ed[0] * expfac + edd[0] * dt4) * tdrag * expfac
        factor_eta = torch.exp(-dthalf * ed[0])
        t_current = t_current * factor_eta * factor_eta
        edd[0] = (tdof * boltz * t_current - ke_target) / eta_mass0
        eta = fst.eta + dthalf * torch.stack(ed[:mt])
        ed[0] = (ed[0] * expfac + edd[0] * dt4) * expfac
        for ich in range(1, mt):
            expfac = torch.exp(-dt8 * ed[ich + 1])
            mass_prev = eta_mass0 if ich == 1 else eta_massk
            edd[ich] = (mass_prev * ed[ich - 1] ** 2
                        - boltz * t_target) / eta_massk
            ed[ich] = (ed[ich] * expfac + edd[ich] * dt4) * expfac
        fst = fst.replace(eta=eta, eta_dot=torch.stack(ed),
                          eta_dotdot=torch.stack(edd))
        return (s.replace(v=self.in_group(s, s.v * factor_eta, s.v)), fst,
                t_current)

    def _omega_mass(self, i, nkt):
        p_freq = 1.0 / self.p_period[i]
        return nkt / (p_freq * p_freq)

    def _nhc_press(self, fst, ctx):
        """nhc_press_integrate: half a step of the barostat's own chain;
        scales the barostat velocities."""
        if not self.mpchain:
            return fst
        boltz, dt = ctx.units.boltz, ctx.dt
        dthalf, dt4, dt8 = 0.5 * dt, 0.25 * dt, 0.125 * dt
        mp = self.mpchain
        pdrag = self.pdrag_factor
        kt = boltz * fst.t_target
        etap_mass = kt / (self.p_freq_max ** 2)
        nkt = (ctx.natoms + 1) * kt
        axes = [i for i in range(6) if self.p_flags[i]]
        masses = torch.stack([self._omega_mass(i, nkt) for i in axes])
        idx = torch.tensor(axes, device=fst.omega_dot.device)
        # iso couples the three axes into one barostat degree of freedom
        lkt_press = kt if self.iso else len(axes) * kt
        ed = list(fst.etap_dot.unbind())
        edd = list(fst.etap_dotdot.unbind())

        def ke_omega(od):
            return torch.sum(masses * od[idx] * od[idx])
        # etap_mass_flag: the upper-chain accelerations from the masses
        for ich in range(1, mp):
            edd[ich] = (etap_mass * ed[ich - 1] ** 2 - kt) / etap_mass
        omega_dot = fst.omega_dot
        edd[0] = (ke_omega(omega_dot) - lkt_press) / etap_mass
        for ich in range(mp - 1, 0, -1):
            expfac = torch.exp(-dt8 * ed[ich + 1])
            ed[ich] = (ed[ich] * expfac + edd[ich] * dt4) * pdrag * expfac
        expfac = torch.exp(-dt8 * ed[1])
        ed[0] = (ed[0] * expfac + edd[0] * dt4) * pdrag * expfac
        etap = fst.etap + dthalf * torch.stack(ed[:mp])
        factor_etap = torch.exp(-dthalf * ed[0])
        flags6 = torch.tensor(self.p_flags, device=omega_dot.device)
        omega_dot = torch.where(flags6, omega_dot * factor_etap, omega_dot)
        edd[0] = (ke_omega(omega_dot) - lkt_press) / etap_mass
        ed[0] = (ed[0] * expfac + edd[0] * dt4) * expfac
        for ich in range(1, mp):
            expfac = torch.exp(-dt8 * ed[ich + 1])
            edd[ich] = (etap_mass * ed[ich - 1] ** 2 - kt) / etap_mass
            ed[ich] = (ed[ich] * expfac + edd[ich] * dt4) * expfac
        return fst.replace(etap=etap, etap_dot=torch.stack(ed),
                           etap_dotdot=torch.stack(edd), omega_dot=omega_dot)

    def _mtk_term2(self, omega_dot, ctx):
        """mtk_term2: the mean diagonal barostat velocity per atom."""
        if not self.mtk:
            return 0.0
        return (torch.sum(torch.where(self._axes(omega_dot), omega_dot[:3],
                                      0.0)) / (self.pdim * ctx.natoms))

    def _omega_dot_update(self, s, fst, ctx, t_current, p_current, mvv):
        """nh_omega_dot: the barostat velocities from the pressure, with the
        MTK term (from the kinetic tensor's diagonal mvv where not iso);
        returns (fix state, mtk_term2)."""
        u = ctx.units
        dthalf = 0.5 * ctx.dt
        vol = s.box.volume
        nkt = (ctx.natoms + 1) * u.boltz * fst.t_target
        pdrag = self.pdrag_factor
        mtk_term1 = 0.0
        if self.mtk:
            if self.iso:
                mtk_term1 = self._tdof(ctx) * u.boltz * t_current
            else:
                mtk_term1 = torch.sum(torch.where(self._axes(s.x), mvv, 0.0))
            mtk_term1 = mtk_term1 / (self.pdim * ctx.natoms)
        p_hydro = self._p_hydro(fst)
        od = list(fst.omega_dot.unbind())
        for i in range(6):
            if not self.p_flags[i]:
                continue
            omega_mass = self._omega_mass(i, nkt)
            # the tilt components take no hydrostatic target and no MTK
            # term (nh_omega_dot :2287)
            f_omega = ((p_current[i] - p_hydro if i < 3 else p_current[i])
                       * vol / (omega_mass * u.nktv2p))
            if self.mtk and i < 3:
                f_omega = f_omega + mtk_term1 / omega_mass
            od[i] = (od[i] + f_omega * dthalf) * pdrag
        omega_dot = torch.stack(od)
        return (fst.replace(omega_dot=omega_dot),
                self._mtk_term2(omega_dot, ctx))

    def _v_press(self, s, fst, ctx, mtk_term2):
        """nh_v_press: v *= exp(-dt/4 (omega_dot + mtk_term2))^2 on the
        barostatted axes; a triclinic barostat applies the tilt couplings
        between the two scalings."""
        od = fst.omega_dot
        fac = torch.where(self._axes(s.x),
                          torch.exp(-0.25 * ctx.dt * (od[:3] + mtk_term2)),
                          1.0)
        if not self.tri:
            return s.replace(v=self.in_group(s, s.v * (fac * fac)[None, :],
                                             s.v))
        dthalf = 0.5 * ctx.dt
        v = s.v * fac[None, :]
        v0 = v[:, 0] - dthalf * (v[:, 1] * od[5] + v[:, 2] * od[4])
        v1 = v[:, 1] - dthalf * v[:, 2] * od[3]
        v = torch.stack([v0, v1, v[:, 2]], dim=1) * fac[None, :]
        return s.replace(v=self.in_group(s, v, s.v))

    def _remap(self, s, fst, ctx):
        """Half-step box dilation about the centre (FixNH::remap
        :1086-1240): positions follow in lamda coordinates; a triclinic
        barostat updates the tilt factors in two time-symmetric halves
        around the diagonal scaling, and unbarostatted tilts scale with
        the cell."""
        dto = 0.5 * ctx.dt
        box = s.box
        od = fst.omega_dot
        tric = box.istriclinic
        lam = box.x2lamda(s.x) if tric else (s.x - box.lo) / box.lengths
        expfac = torch.exp(dto * od[:3])
        center = 0.5 * (box.lo + box.hi)
        flags = self._axes(s.x)
        lo = torch.where(flags, (box.lo - center) * expfac + center, box.lo)
        hi = torch.where(flags, (box.hi - center) * expfac + center, box.hi)
        fst = fst.replace(omega=fst.omega + dto * od)
        if not tric:
            return s.replace(x=lo + lam * (hi - lo),
                             box=box.replace(lo=lo, hi=hi)), fst
        # h in Voigt order: h[1], h[2] the lengths, h3 yz, h4 xz, h5 xy
        h1, h2 = box.lengths[1], box.lengths[2]
        h5, h4, h3 = box.tilt.unbind()
        pf = self.p_flags

        def offdiag_half(h3, h4, h5):
            dto2, dto4, dto8 = dto / 2.0, dto / 4.0, dto / 8.0
            if pf[4]:
                e = torch.exp(dto8 * od[0])
                h4 = (h4 * e + dto4 * (od[5] * h3 + od[4] * h2)) * e
            if pf[3]:
                e = torch.exp(dto4 * od[1])
                h3 = (h3 * e + dto2 * od[3] * h2) * e
            if pf[5]:
                e = torch.exp(dto4 * od[0])
                h5 = (h5 * e + dto2 * od[5] * h1) * e
            if pf[4]:
                e = torch.exp(dto8 * od[0])
                h4 = (h4 * e + dto4 * (od[5] * h3 + od[4] * h2)) * e
            return h3, h4, h5
        if self.tri:
            h3, h4, h5 = offdiag_half(h3, h4, h5)
        # unbarostatted tilts scale with the cell (remap :1165-1176)
        if pf[1] and self.scalexy:
            h5 = h5 * expfac[1]
        if pf[2] and self.scalexz:
            h4 = h4 * expfac[2]
        if pf[2] and self.scaleyz:
            h3 = h3 * expfac[2]
        if self.tri:
            # domain->h[1], h[2] refresh only after remap: both halves use
            # the lengths from before the scaling
            h3, h4, h5 = offdiag_half(h3, h4, h5)
        new_box = box.replace(lo=lo, hi=hi, tilt=torch.stack([h5, h4, h3]))
        return s.replace(x=new_box.lamda2x(lam), box=new_box), fst

    # ------------------------------------------------------------- hooks
    def initial_integrate(self, s, fst, ctx):
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        # the barostat's chain uses the previous step's t_target
        fst = self._nhc_press(fst, ctx)
        t_current = self._t_current(s, ctx)
        if self.tstat:
            fst = fst.replace(t_target=torch.full_like(
                fst.t_target, self._temp_target(fst)))
            s, fst, t_current = self._nhc_temp(s, fst, ctx, t_current)
        if self.pstat:
            _, mvv, od = self._kinetic(s, ctx, False, True)
            p_current = self._p_current(s, ctx, fst.virial, mvv, od)
            fst, mtk_term2 = self._omega_dot_update(s, fst, ctx, t_current,
                                                    p_current, mvv)
            s = self._v_press(s, fst, ctx, mtk_term2)
        s = s.replace(v=self.in_group(s, torch.addcmul(
            s.v, (dtf / ctx.mass_per_atom(s))[:, None], s.f), s.v))
        if self.pstat:
            s, fst = self._remap(s, fst, ctx)
        s = s.replace(x=self.in_group(s, s.x + ctx.dt * s.v, s.x))
        if self.pstat:
            s, fst = self._remap(s, fst, ctx)
        return s, fst

    def final_integrate(self, s, fst, ctx):
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        s = s.replace(v=self.in_group(s, torch.addcmul(
            s.v, (dtf / ctx.mass_per_atom(s))[:, None], s.f), s.v))
        if self.pstat:
            s = self._v_press(s, fst, ctx,
                              self._mtk_term2(fst.omega_dot, ctx))
        t_current, mvv, od = self._kinetic(s, ctx, True, self.pstat)
        if self.pstat:
            p_current = self._p_current(s, ctx, fst.virial, mvv, od)
            fst, _ = self._omega_dot_update(s, fst, ctx, t_current,
                                            p_current, mvv)
        if self.tstat:
            s, fst, _ = self._nhc_temp(s, fst, ctx, t_current)
        return s, self._nhc_press(fst, ctx)


def make_nvt(t_start, t_stop, t_period, tchain=3):
    return FixNH(t_start, t_stop, t_period, tchain=tchain)


def make_npt_z(t_start, t_stop, t_period, p_start, p_stop, p_period,
               tchain=3):
    """npt coupled along z only, without the barostat's chain and the MTK
    terms (the rhodo_class deck's barostat, pchain 0 mtk no)."""
    return FixNH(t_start, t_stop, t_period, p_flags=(False, False, True),
                 p_start=(0.0, 0.0, p_start), p_stop=(0.0, 0.0, p_stop),
                 p_period=(0.0, 0.0, p_period), tchain=tchain, pchain=0,
                 mtk=False)
