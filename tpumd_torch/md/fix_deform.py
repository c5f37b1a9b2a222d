"""fix deform: prescribed box deformation (src/fix_deform.cpp).

The port of tpumd/md/fix_deform.py: per axis the styles final lo hi,
scale s, vel V, erate R and delta dlo dhi, and remap x (the default: the
atoms follow the box in lamda coordinates) or remap none.  At the end of
every Nth step the box takes the linear target of the run's elapsed
fraction (the reference's set[i].lo_target), measured from the box at
the fix's first set-up.  The box moves after the force evaluation whose
energies thermo reports (``eos_box_change``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.md.fixes import Fix

# the number of values each style takes
NARGS = {"final": 2, "delta": 2, "scale": 1, "vel": 1, "erate": 1}


def final_bounds(spec, lo0: float, hi0: float, t_total: float):
    """(lo, hi) of one axis at the end of a run of t_total time units."""
    style = spec[0]
    if style == "final":
        return spec[1], spec[2]
    if style == "delta":
        return lo0 + spec[1], hi0 + spec[2]
    center, half = 0.5 * (lo0 + hi0), 0.5 * (hi0 - lo0)
    if style == "scale":
        half = half * spec[1]
    elif style == "vel":
        half = half + 0.5 * spec[1] * t_total
    else:
        half = half * (1.0 + spec[1] * t_total)
    return center - half, center + half


class FixDeform(Fix):
    name = "deform"
    needs_step = True
    box_change = True
    eos_box_change = True

    def __init__(self, nevery, specs, remap="x"):
        self.nevery = max(int(nevery), 1)
        self.specs = dict(specs)       # axis -> (style, values...)
        for spec in self.specs.values():
            if spec[0] not in NARGS:
                raise NotImplementedError(
                    f"fix deform style {spec[0]!r} is not ported (final, "
                    "delta, scale, vel, erate)")
        if remap not in ("x", "none"):
            raise NotImplementedError(f"fix deform remap {remap} is not "
                                      "ported (x, none)")
        self.remap = remap

    def init_state(self, s, ctx):
        if s.box.istriclinic:
            raise NotImplementedError("fix deform on a triclinic box is not "
                                      "ported")
        return {"lo0": s.box.lo.clone(), "hi0": s.box.hi.clone(),
                "step": 0, "begin": 0, "end": 0}

    def set_step(self, fstate, istep):
        return {**fstate, "step": istep}

    def pre_run(self, fstate, begin, end):
        return {**fstate, "begin": begin, "end": end}

    def _targets(self, fst, ctx):
        """(lo, hi) targets at the current step (tpumd/md/fix_deform.py:
        54-94)."""
        num = fst["step"] - fst["begin"]
        delta = min(max(num / max(fst["end"] - fst["begin"], 1), 0.0), 1.0)
        t_elapsed = num * ctx.dt
        lo, hi = list(fst["lo0"].unbind()), list(fst["hi0"].unbind())
        for d, spec in self.specs.items():
            lo0, hi0 = lo[d], hi[d]
            style = spec[0]
            if style == "final":
                lo[d] = lo0 + delta * (spec[1] - lo0)
                hi[d] = hi0 + delta * (spec[2] - hi0)
            elif style == "delta":
                lo[d] = lo0 + delta * spec[1]
                hi[d] = hi0 + delta * spec[2]
            else:
                center = 0.5 * (lo0 + hi0)
                if style == "scale":
                    half = 0.5 * (hi0 - lo0) * (1.0 + delta * (spec[1] - 1.0))
                elif style == "vel":
                    half = 0.5 * (hi0 - lo0) + 0.5 * spec[1] * t_elapsed
                else:
                    half = 0.5 * (hi0 - lo0) * (1.0 + spec[1] * t_elapsed)
                lo[d], hi[d] = center - half, center + half
        return torch.stack(lo), torch.stack(hi)

    def end_of_step(self, s, fst, ctx):
        if fst["step"] % self.nevery:
            return s, fst
        lo, hi = self._targets(fst, ctx)
        box = s.box
        x = s.x
        if self.remap == "x":
            x = lo + (s.x - box.lo) / box.lengths * (hi - lo)
        return s.replace(x=x, box=box.replace(lo=lo, hi=hi)), fst

    def current_rates(self, sim, fstate):
        """(h_rate (3,), h_ratelo (3,)): the box's rate of change over the
        run's window, for compute temp/deform's streaming velocity (the
        reference's Domain::h_rate and h_ratelo, which FixDeform::init
        sets from the linear targets)."""
        lo0 = fstate["lo0"].detach().cpu().double().numpy()
        hi0 = fstate["hi0"].detach().cpu().double().numpy()
        t_total = max(fstate["end"] - fstate["begin"], 1) * sim._ctx.dt
        h_rate, h_ratelo = np.zeros(3), np.zeros(3)
        for d, spec in self.specs.items():
            lo_f, hi_f = final_bounds(spec, lo0[d], hi0[d], t_total)
            h_rate[d] = ((hi_f - lo_f) - (hi0[d] - lo0[d])) / t_total
            h_ratelo[d] = (lo_f - lo0[d]) / t_total
        return h_rate, h_ratelo
