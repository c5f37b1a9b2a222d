"""Local computes: one row per bond, angle or pair, for dump local.

The port of tpumd/md/compute_local.py: compute property/local
(src/compute_property_local.cpp), bond/local (src/compute_bond_local.cpp)
and angle/local (src/compute_angle_local.cpp).  The tuples are the run's
live topology (``Simulation.live_topology``: the data file's or the
templates', less the bonds fix bond/break broke and with those fix
bond/create made), in its row order; the distances and angles are taken in
float64 on the device from the atoms in tag order, each bond's energy and
force from its style's ``bond_fn``.  The pair rows of property/local come
from the output state's device pair list (``md/compute_list.py``) at the
pair style's cutoff, i < j.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.md import peratom as pa
from tpumd_torch.md.compute_list import pair_edges
from tpumd_torch.md.compute_styles import Compute

_TUPLE_COLS = {
    "batom1": ("bond", 1), "batom2": ("bond", 2), "btype": ("bond", 0),
    "aatom1": ("angle", 1), "aatom2": ("angle", 2), "aatom3": ("angle", 3),
    "atype": ("angle", 0),
    "datom1": ("dihedral", 1), "datom2": ("dihedral", 2),
    "datom3": ("dihedral", 3), "datom4": ("dihedral", 4),
    "dtype": ("dihedral", 0),
    "iatom1": ("improper", 1), "iatom2": ("improper", 2),
    "iatom3": ("improper", 3), "iatom4": ("improper", 4),
    "itype": ("improper", 0),
}
_PAIR_COLS = ("patom1", "patom2", "ptype1", "ptype2")


def _tuples(sim, kind):
    """(M, 1 + arity) int64 tuples of kind on the run's device."""
    arr = sim.live_topology(kind)
    a = pa.atoms(sim)
    if arr is None:
        return torch.zeros((0, 5), dtype=torch.int64, device=a.x.device)
    return torch.as_tensor(np.asarray(arr, np.int64), device=a.x.device)


class LocalCompute(Compute):
    scalar = False
    is_local = True

    def __init__(self, cid, group, args):
        super().__init__(cid, group, args)
        self.cols = list(args)
        if not self.cols:
            raise ValueError(f"compute {self.style} needs columns")


class ComputePropertyLocal(LocalCompute):
    """compute ID group property/local batom1 batom2 btype ... | patom1
    patom2 ptype1 ptype2: the columns of one tuple kind."""

    style = "property/local"

    def __init__(self, cid, group, args):
        super().__init__(cid, group, args)
        kinds = set()
        for c in self.cols:
            if c in _TUPLE_COLS:
                kinds.add(_TUPLE_COLS[c][0])
            elif c in _PAIR_COLS:
                kinds.add("pair")
            else:
                raise NotImplementedError(
                    f"compute property/local column {c!r} is not ported")
        if len(kinds) != 1:
            raise ValueError("compute property/local columns must name "
                             "one tuple kind")
        self.kind = kinds.pop()

    def list_cutoff(self, sim):
        """The pair columns read the device list at the force cutoff."""
        if self.kind != "pair" or sim.pair is None:
            return 0.0
        return sim.pair.max_cutoff

    def evaluate(self, sim):
        if self.kind == "pair":
            a = pa.atoms(sim)
            e = pair_edges(sim, sim.pair.max_cutoff)
            keep = e.i < e.j
            i, j = e.i[keep], e.j[keep]
            out = {"patom1": a.tag[i], "patom2": a.tag[j],
                   "ptype1": a.type[i], "ptype2": a.type[j]}
            return torch.stack([out[c].to(torch.float64)
                                for c in self.cols], dim=1)
        t = _tuples(sim, self.kind)
        return torch.stack([t[:, _TUPLE_COLS[c][1]].to(torch.float64)
                            for c in self.cols], dim=1)


class ComputeBondLocal(LocalCompute):
    """compute ID group bond/local dist engpot force (eng = engpot): per
    bond its length, its energy and the magnitude of its force, from the
    one bond style."""

    style = "bond/local"

    def __init__(self, cid, group, args):
        super().__init__(cid, group, args)
        bad = [c for c in self.cols
               if c not in ("dist", "engpot", "force", "eng")]
        if bad:
            raise NotImplementedError(
                f"compute bond/local columns {bad} are not ported (only "
                "dist, engpot, eng and force)")

    def evaluate(self, sim):
        style = sim.bonded.get("bond")
        if style is None or not hasattr(style, "bond_fn"):
            raise ValueError("compute bond/local needs one bond style "
                             "with a bond_fn (not hybrid)")
        a = pa.atoms(sim)
        t = _tuples(sim, "bond")
        d = pa.min_image(a.x[t[:, 1] - 1] - a.x[t[:, 2] - 1], a)
        r2 = torch.sum(d * d, dim=1)
        fbond, ebond = style.bond_fn(r2, t[:, 0])
        r = torch.sqrt(r2)
        cols = {"dist": r, "engpot": ebond, "eng": ebond,
                "force": fbond * r}
        return torch.stack([cols[c].to(torch.float64) for c in self.cols],
                           dim=1)


class ComputeAngleLocal(LocalCompute):
    """compute ID group angle/local theta: each angle in degrees."""

    style = "angle/local"

    def __init__(self, cid, group, args):
        super().__init__(cid, group, args)
        if self.cols != ["theta"]:
            raise NotImplementedError(
                f"compute angle/local columns {self.cols} are not ported "
                "(theta only)")

    def evaluate(self, sim):
        a = pa.atoms(sim)
        t = _tuples(sim, "angle")
        d1 = pa.min_image(a.x[t[:, 1] - 1] - a.x[t[:, 2] - 1], a)
        d2 = pa.min_image(a.x[t[:, 3] - 1] - a.x[t[:, 2] - 1], a)
        c = torch.sum(d1 * d2, dim=1) / torch.sqrt(
            torch.sum(d1 * d1, dim=1) * torch.sum(d2 * d2, dim=1))
        return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))[:, None]


STYLES = (ComputePropertyLocal, ComputeBondLocal, ComputeAngleLocal)
