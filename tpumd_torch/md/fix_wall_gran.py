"""fix wall/gran: frictional granular wall (classic models).

The port of tpumd/md/fix_wall_gran.py (FixWallGran, src/GRANULAR/
fix_wall_gran.cpp, with the classic contact models of the GranularModel
framework: granular_model.cpp:360-460, gran_sub_mod_normal.cpp,
gran_sub_mod_tangential.cpp, gran_sub_mod_damping.cpp):

- hooke:          Fn = kn delta - gamman meff vnnr; the tangential force is
                  velocity damping capped by Coulomb friction
                  (linear_nohistory).
- hooke/history:  a tangential spring on the per-atom wall shear history,
                  scaled by the contact radius sqrt(delta Reff)
                  (linear_history_classic with contact_radius_flag).
- hertz/history:  kn and kt converted from pressure units (/nktv2p), the
                  normal force and damping scaled by the contact radius
                  (hertz + viscoelastic + mindlin_classic).

Walls xplane, yplane, zplane (lo and hi, NULL = open) and zcylinder
(radius), with wiggle (an oscillating wall) or shear (a moving wall).

One elementwise pass over the (N,) atoms per wall, in plain PyTorch, as
tpumd has it in plain JAX.  The per-atom (N, 3) shear history is the
fix's state; it lives in the atoms' per-atom tables (``MDState.peratom``
under ``history_key``), so that every re-bin, compaction and insertion
moves it with its atom.
"""

from __future__ import annotations

import math

import torch

from tpumd_torch.md.fixes import Fix

BIG = 1.0e20


class FixWallGran(Fix):
    name = "wall/gran"
    needs_step = True

    def __init__(self, model, kn, kt, gamman, gammat, xmu, dampflag,
                 wallstyle, *args):
        if model not in ("hooke", "hooke/history", "hertz/history"):
            raise NotImplementedError(
                f"fix wall/gran model {model!r} is not ported (hooke, "
                "hooke/history, hertz/history)")
        self.model = model
        self.kn = float(kn)
        self.kt = self.kn * 2.0 / 7.0 if kt == "NULL" else float(kt)
        self.gamman = float(gamman)
        self.gammat = (0.5 * self.gamman if gammat == "NULL"
                       else float(gammat))
        self.xmu = float(xmu)
        if int(dampflag) == 0:
            self.gammat = 0.0
        self.use_history = model != "hooke"
        self.wallstyle = wallstyle
        args = list(args)
        if wallstyle in ("xplane", "yplane", "zplane"):
            if len(args) < 2:
                raise ValueError(f"fix wall/gran {wallstyle}: lo and hi")
            self.lo = -BIG if args[0] == "NULL" else float(args[0])
            self.hi = BIG if args[1] == "NULL" else float(args[1])
            self.axis0 = "xyz".index(wallstyle[0])
            rest = args[2:]
        elif wallstyle == "zcylinder":
            self.cylradius = float(args[0])
            self.axis0 = None
            rest = args[1:]
        else:
            raise NotImplementedError(
                f"fix wall/gran wallstyle {wallstyle!r} is not ported "
                "(xplane, yplane, zplane, zcylinder)")
        self.wiggle = self.wshear = False
        i = 0
        while i < len(rest):
            if rest[i] == "wiggle":
                self.wiggle = True
                self.waxis = "xyz".index(rest[i + 1])
                self.amplitude = float(rest[i + 2])
                self.period = float(rest[i + 3])
                i += 4
            elif rest[i] == "shear":
                self.wshear = True
                self.waxis = "xyz".index(rest[i + 1])
                self.vshear = float(rest[i + 2])
                i += 3
            else:
                raise NotImplementedError(
                    f"fix wall/gran keyword {rest[i]!r} is not ported "
                    "(wiggle, shear)")
        if self.wiggle and self.wshear:
            raise ValueError("fix wall/gran cannot both wiggle and shear")

    @property
    def history_key(self) -> str:
        """The key of this fix's shear history in MDState.peratom."""
        return f"fix {self.id} wall/gran"

    def _k_local(self, ctx):
        if self.model == "hertz/history":
            # classic hertz takes kn and kt in pressure units
            # (granular_model.cpp:define_classic_model)
            return self.kn / ctx.units.nktv2p, self.kt / ctx.units.nktv2p
        return self.kn, self.kt

    # ------------------------------------------------------------ state
    def init_state(self, s, ctx):
        """The step of the last set_step (the wiggle's phase), 0 at
        set-up as in tpumd."""
        return 0

    def set_step(self, fstate, istep):
        return istep

    def setup_post_force(self, s, fstate, ctx, xin=None):
        # the reference's history_update = 0 during setup
        return self._apply(s, fstate, ctx, shearupdate=False)

    def post_force(self, s, fstate, ctx, xin=None):
        return self._apply(s, fstate, ctx, shearupdate=True)

    # ------------------------------------------------------------ force
    def _apply(self, s, istep, ctx, shearupdate):
        history = None
        if self.use_history:
            table = dict(s.peratom or {})
            history = table.get(self.history_key)
            if history is None or history.shape != s.x.shape:
                history = torch.zeros_like(s.x)
        x, v, omega, rad = s.x, s.v, s.omega, s.radius
        m = ctx.mass_per_atom(s)
        zero = torch.zeros_like(rad)

        wlo = getattr(self, "lo", 0.0)
        whi = getattr(self, "hi", 0.0)
        vwall = [zero, zero, zero]
        if self.wiggle:
            omega_w = 2.0 * math.pi / self.period
            arg = omega_w * float(istep) * ctx.dt
            if self.wallstyle != "zcylinder" and self.waxis == self.axis0:
                off = self.amplitude - self.amplitude * math.cos(arg)
                wlo, whi = wlo + off, whi + off
            vwall[self.waxis] = zero + self.amplitude * omega_w \
                * math.sin(arg)
        elif self.wshear and self.wallstyle != "zcylinder":
            vwall[self.waxis] = zero + self.vshear

        if self.wallstyle != "zcylinder":
            c = self.axis0
            del1 = x[:, c] - wlo
            del2 = whi - x[:, c]
            d = [zero, zero, zero]
            d[c] = torch.where(del1 < del2, del1, -del2)
        else:
            delxy = torch.clamp(torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2),
                                min=1e-30)
            delr = self.cylradius - delxy
            incontact = delr <= rad
            d = [torch.where(incontact, -delr / delxy * x[:, 0], 0.0),
                 torch.where(incontact, -delr / delxy * x[:, 1], 0.0),
                 torch.where(incontact, zero, zero + self.cylradius)]
            if self.wshear and self.waxis != 2:
                vwall = [vwall[0] + self.vshear * x[:, 1] / delxy,
                         vwall[1] - self.vshear * x[:, 0] / delxy, zero]

        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        touching = self.group_sel(s) & (rsq < rad * rad) & (rad > 0)
        r = torch.sqrt(torch.where(touching, rsq, 1.0))
        rinv = 1.0 / r
        nx = [d[c] * rinv for c in range(3)]
        delta = rad - r

        # Reff: a flat wall radi; a cylinder radi rwall / (radi + rwall)
        # with rwall = -+2 cylradius (granular_model.cpp:362-369)
        if self.wallstyle == "zcylinder":
            rwall = torch.where(delxy < self.cylradius,
                                zero - 2.0 * self.cylradius,
                                zero + 2.0 * self.cylradius)
            reff = rad * rwall / (rad + rwall)
        else:
            reff = rad
        ctr = torch.sqrt(torch.clamp(delta * reff, min=0.0))  # contact radius

        vr = [v[:, c] - vwall[c] for c in range(3)]
        vnnr = vr[0] * nx[0] + vr[1] * nx[1] + vr[2] * nx[2]
        vt = [vr[c] - nx[c] * vnnr for c in range(3)]
        # wr = radi omega_i (the wall does not spin); vtr = vt - wr x nx
        wr = [rad * omega[:, c] for c in range(3)]
        vtr = [vt[0] - (wr[1] * nx[2] - wr[2] * nx[1]),
               vt[1] - (wr[2] * nx[0] - wr[0] * nx[2]),
               vt[2] - (wr[0] * nx[1] - wr[1] * nx[0])]
        vrel = torch.sqrt(vtr[0] ** 2 + vtr[1] ** 2 + vtr[2] ** 2)
        meff = m

        kn, kt = self._k_local(ctx)
        if self.model == "hertz/history":
            fnormal = kn * ctr * delta
            damp_pref = self.gamman * meff * ctr
        else:
            fnormal = kn * delta
            damp_pref = self.gamman * meff
        fntot = fnormal - damp_pref * vnnr
        fncrit = torch.abs(fntot)
        fscrit = self.xmu * fncrit
        xt = self.gammat / self.gamman if self.gamman else 0.0
        damp_t = xt * damp_pref

        if not self.use_history:
            # linear_nohistory (gran_sub_mod_tangential.cpp:69-84) reads
            # its two coefficients from the three that define_classic_model
            # writes (kt, gammat/gamman, xmu): xt = kt and mu = gammat /
            # gamman, as tpumd reproduces from the built binary
            mu_q = self.gammat / self.gamman if self.gamman else 0.0
            fsmag = kt * damp_pref * vrel
            ft = torch.where(vrel != 0.0,
                             torch.minimum(mu_q * fncrit, fsmag)
                             / torch.where(vrel != 0.0, vrel, 1.0), 0.0)
            fs = [-ft * vtr[c] for c in range(3)]
        else:
            # linear_history_classic / mindlin_classic (:176-233): the
            # tangential spring scaled by the contact radius
            hist = [torch.where(touching, history[:, c], 0.0)
                    for c in range(3)]
            if shearupdate:
                hist = [hist[c] + ctx.dt * vtr[c] for c in range(3)]
            shrmag = torch.sqrt(hist[0] ** 2 + hist[1] ** 2 + hist[2] ** 2)
            if shearupdate:
                rsht = hist[0] * nx[0] + hist[1] * nx[1] + hist[2] * nx[2]
                hist = [hist[c] - rsht * nx[c] for c in range(3)]
            fs = [-kt * ctr * hist[c] - damp_t * vtr[c] for c in range(3)]
            magfs = torch.sqrt(fs[0] ** 2 + fs[1] ** 2 + fs[2] ** 2)
            slip = touching & (magfs > fscrit)
            ratio = fscrit / torch.where(magfs > 0, magfs, 1.0)
            resc = slip & (shrmag != 0.0)
            hist = [torch.where(resc, -(ratio * fs[c] + damp_t * vtr[c]) / kt,
                                hist[c]) for c in range(3)]
            fs = [torch.where(slip, torch.where(shrmag != 0.0, fs[c] * ratio,
                                                0.0), fs[c])
                  for c in range(3)]
            if shearupdate:
                history = torch.stack(
                    [torch.where(touching, hist[c], 0.0) for c in range(3)],
                    dim=1)
            else:
                history = torch.where(touching[:, None], history, 0.0)
            table[self.history_key] = history
            s = s.replace(peratom=table)

        fw = torch.stack([torch.where(touching, fntot * nx[c] + fs[c], 0.0)
                          for c in range(3)], dim=1)
        # torque_i = -radi (nx x fs)  (granular_model.cpp:439-452)
        tq = [rad * (nx[1] * fs[2] - nx[2] * fs[1]),
              rad * (nx[2] * fs[0] - nx[0] * fs[2]),
              rad * (nx[0] * fs[1] - nx[1] * fs[0])]
        torque = s.torque - torch.stack(
            [torch.where(touching, tq[c], 0.0) for c in range(3)], dim=1)
        return s.replace(f=s.f + fw, torque=torque), istep
