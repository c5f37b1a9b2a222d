"""The rest of the compute library: style energies (pair, bond, angle,
dihedral, improper), bias temperatures (temp/ramp, temp/profile,
temp/sphere, temp/deform), erotate/sphere/atom, slice, reduce/region,
chunk/spread/atom, global/atom, reduce/chunk, fragment/atom and
aggregate/atom.

The port of tpumd/md/compute_extra.py (src/compute_pair.cpp,
compute_bond.cpp, compute_angle.cpp, compute_dihedral.cpp,
compute_improper.cpp, compute_temp_ramp.cpp, compute_temp_profile.cpp,
compute_temp_sphere.cpp, compute_temp_deform.cpp,
compute_erotate_sphere_atom.cpp,
compute_slice.cpp, compute_reduce_region.cpp,
compute_chunk_spread_atom.cpp, compute_global_atom.cpp,
compute_reduce_chunk.cpp, compute_fragment_atom.cpp,
compute_aggregate_atom.cpp), on the device.  fragment/atom and
aggregate/atom label clusters by propagating the smallest tag over the
bonds (and, for aggregate, the pairs within its cutoff) until nothing
changes, as cluster/atom does.  temp/deform reads the rates of the deck's
fix deform.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.md import peratom as pa
from tpumd_torch.md.compute_pair import ComputeClusterAtom, fix_dof, \
    bias_temp, min_label
from tpumd_torch.md.compute_styles import Compute, expand_wildcards, \
    fix_output, peratom_input, reduce_fn, split_ref


def _energy(sim, key):
    e, _ = sim.current_energies()
    return e[key].to(torch.float64)


class ComputePairEnergy(Compute):
    """compute pair pstyle [evdwl|ecoul|epair]: the pair style's energy,
    evdwl + ecoul as a vector [evdwl, ecoul], or one of them
    (src/compute_pair.cpp:112-139; tail excluded)."""

    style = "pair"
    scalar = False
    extensive = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        if not args:
            raise ValueError("compute pair needs a pair style name")
        self.pstyle = args[0]
        self.which = args[1] if len(args) > 1 else "epair"
        self.scalar = self.which != "epair"

    def evaluate(self, sim):
        pname = getattr(sim.pair, "name", None)
        if pname is None:
            raise ValueError("compute pair: no pair style defined")
        if pname != self.pstyle:
            raise ValueError(f"compute pair style {self.pstyle!r} does not "
                             f"match defined pair style {pname!r}")
        ev, ec = _energy(sim, "evdwl"), _energy(sim, "ecoul")
        if self.which == "evdwl":
            return ev
        if self.which == "ecoul":
            return ec
        return torch.stack([ev, ec])


class BondedEnergy(Compute):
    """The energy of one bonded kind (compute_bond.cpp and siblings)."""

    ekey = None
    extensive = True

    def evaluate(self, sim):
        return _energy(sim, self.ekey)


class ComputeBondEnergy(BondedEnergy):
    style, ekey = "bond", "ebond"


class ComputeAngleEnergy(BondedEnergy):
    style, ekey = "angle", "eangle"


class ComputeDihedralEnergy(BondedEnergy):
    style, ekey = "dihedral", "edihed"


class ComputeImproperEnergy(BondedEnergy):
    style, ekey = "improper", "eimp"


class ComputeTempRamp(Compute):
    """compute temp/ramp vdim vlo vhi dim clo chi: the temperature with a
    linear velocity ramp removed (src/compute_temp_ramp.cpp)."""

    style = "temp/ramp"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.v_dim = "xyz".index(args[0].lstrip("v"))
        self.v_lo, self.v_hi = float(args[1]), float(args[2])
        self.c_dim = "xyz".index(args[3])
        self.c_lo, self.c_hi = float(args[4]), float(args[5])

    def evaluate(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        frac = torch.clamp((a.x[:, self.c_dim] - self.c_lo)
                           / (self.c_hi - self.c_lo), 0.0, 1.0)
        vt = a.v.clone()
        vt[:, self.v_dim] -= self.v_lo + frac * (self.v_hi - self.v_lo)
        ms = torch.where(sel, a.mass, 0.0)
        dof = sim.dimension * int(sel.sum()) - sim.dimension - fix_dof(sim)
        return bias_temp(sim, (ms * (vt * vt).sum(1)).sum(), dof)


class ComputeTempProfile(Compute):
    """compute temp/profile xflag yflag zflag bin dims n...: the per-bin
    mean streaming velocity removed; dof less nstreaming * nbins
    (src/compute_temp_profile.cpp:197-252)."""

    style = "temp/profile"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.flags = [int(args[0]), int(args[1]), int(args[2])]
        if args[3] != "bin":
            raise NotImplementedError("temp/profile: only the bin binning "
                                      "style is ported")
        self.bin_dims = ["xyz".index(t) for t in args[4]]
        self.nbin = [int(args[5 + k]) for k in range(len(self.bin_dims))]

    def evaluate(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        ids = torch.zeros(a.n, dtype=torch.int64, device=a.x.device)
        nbins = 1
        for d, nb in zip(self.bin_dims, self.nbin):
            ib = torch.clamp(((a.x[:, d] - a.lo[d]) / (a.hi[d] - a.lo[d])
                              * nb).long(), 0, nb - 1)
            ids = ids * nb + ib
            nbins *= nb
        ms = torch.where(sel, a.mass, 0.0)
        vt = a.v.clone()
        nstream = 0
        for d in range(3):
            if not self.flags[d]:
                continue
            nstream += 1
            wsum = torch.bincount(ids, weights=ms, minlength=nbins)
            vsum = torch.bincount(ids, weights=ms * a.v[:, d],
                                  minlength=nbins)
            vt[:, d] -= (vsum / torch.clamp(wsum, min=1e-300))[ids]
        dof = (sim.dimension * int(sel.sum()) - sim.dimension
               - fix_dof(sim) - nstream * nbins)
        return bias_temp(sim, (ms * (vt * vt).sum(1)).sum(), dof)


class ComputeTempSphere(Compute):
    """compute temp/sphere [dof all|rotate]: translational and rotational
    KE of finite spheres, 3 more dof (1 in 2d) per finite sphere with dof
    all (src/compute_temp_sphere.cpp)."""

    style = "temp/sphere"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.dof_mode = "all"
        if len(args) >= 2 and args[0] == "dof":
            self.dof_mode = args[1]

    def evaluate(self, sim):
        a = pa.atoms(sim)
        if a.omega is None:
            raise ValueError("compute temp/sphere needs atom_style sphere")
        sel = self.sel(sim)
        ms = torch.where(sel, a.rmass, 0.0)
        inertia = 0.4 * ms * a.radius * a.radius
        ke = (ms * (a.v * a.v).sum(1)).sum() \
            + (inertia * (a.omega * a.omega).sum(1)).sum()
        dof = sim.dimension * int(sel.sum()) - sim.dimension - fix_dof(sim)
        if self.dof_mode == "all":
            dof += (3 if sim.dimension == 3 else 1) * int(
                (sel & (a.radius > 0)).sum())
        return bias_temp(sim, ke, dof)


class ComputeTempDeform(Compute):
    """compute temp/deform: the temperature with the streaming velocity of
    the box's deformation removed, vstream = h_rate lamda + h_ratelo
    (src/compute_temp_deform.cpp:120-175), the rates those of the deck's
    fix deform over its run (0 without one)."""

    style = "temp/deform"

    @staticmethod
    def _rates(sim):
        from tpumd_torch.md.fix_deform import FixDeform
        for fx, fs in zip(sim.fixes, sim._carry[2]):
            if isinstance(fx, FixDeform):
                return fx.current_rates(sim, fs)
        return np.zeros(3), np.zeros(3)

    def evaluate(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        h_rate, h_ratelo = (torch.as_tensor(r, dtype=a.x.dtype,
                                            device=a.x.device)
                            for r in self._rates(sim))
        lam = (a.x - a.lo) / torch.clamp(a.hi - a.lo, min=1e-300)
        vt = a.v - (lam * h_rate + h_ratelo)
        ms = torch.where(sel, a.mass, 0.0)
        dof = sim.dimension * int(sel.sum()) - sim.dimension - fix_dof(sim)
        return bias_temp(sim, (ms * (vt * vt).sum(1)).sum(), dof)


class ComputeERotateSphereAtom(Compute):
    """Per-atom rotational KE of spheres
    (src/compute_erotate_sphere_atom.cpp)."""

    style = "erotate/sphere/atom"
    scalar = False
    peratom = True

    def evaluate(self, sim):
        a = pa.atoms(sim)
        if a.omega is None:
            raise ValueError("compute erotate/sphere/atom needs atom_style "
                             "sphere")
        e = 0.5 * sim.units.mvv2e * 0.4 * a.rmass * a.radius * a.radius \
            * (a.omega * a.omega).sum(1)
        return torch.where(self.sel(sim), e, 0.0)


def global_input(sim, name):
    """A global vector (a column of a global array) of c_ or f_ (or, for
    global/atom, an equal- or vector-style v_) input."""
    kind, base, col = split_ref(name)
    if kind == "c":
        out = sim.computes[base](sim)
    elif kind == "f":
        out = torch.as_tensor(np.asarray(fix_output(sim, base), np.float64),
                              device=pa.atoms(sim).x.device)
    elif kind == "v":
        out = torch.as_tensor(np.asarray(sim.script.evaluate_variable(base),
                                         np.float64),
                              device=pa.atoms(sim).x.device)
    else:
        raise ValueError(f"input {name!r} must be c_, f_ or v_")
    out = torch.atleast_1d(out)
    if out.dim() == 2 and col is not None:
        out = out[:, col]
    return out


class ComputeSlice(Compute):
    """compute slice Nstart Nstop Nskip input...: rows of global vectors
    or array columns (src/compute_slice.cpp)."""

    style = "slice"
    scalar = False

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.start, self.stop, self.skip = (int(args[0]), int(args[1]),
                                            int(args[2]))
        self.inputs = list(args[3:])
        bad = [nm for nm in self.inputs if not nm.startswith(("c_", "f_"))]
        if bad:
            raise ValueError(f"slice inputs {bad} must be c_ or f_")

    def evaluate(self, sim):
        rows = slice(self.start - 1, self.stop, self.skip)
        cols = [global_input(sim, nm)[rows] for nm in self.inputs]
        return cols[0] if len(cols) == 1 else torch.stack(cols, dim=1)


class ComputeReduceRegion(Compute):
    """compute reduce/region region mode inputs: reduce over the atoms
    inside the region (src/compute_reduce_region.cpp)."""

    style = "reduce/region"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.region = args[0]
        self.mode = args[1]
        self.inputs = list(args[2:])
        self.extensive = self.mode in ("sum", "sumsq")
        self.scalar = len(self.inputs) == 1

    def evaluate(self, sim):
        a = pa.atoms(sim)
        reg = sim.script.regions[self.region]
        inside = torch.as_tensor(reg.inside(a.x.cpu().numpy()),
                                 device=a.x.device) & self.sel(sim)
        fn = reduce_fn(self.mode)
        outs = []
        for nm in expand_wildcards(sim, self.inputs):
            col = peratom_input(sim, nm)[inside]
            outs.append(fn(col) if col.numel() else col.new_zeros(()))
        out = torch.stack(outs)
        return out[0] if self.scalar else out


class ComputeChunkSpreadAtom(Compute):
    """compute chunk/spread/atom chunkID input...: each atom gets its
    chunk's global value (src/compute_chunk_spread_atom.cpp)."""

    style = "chunk/spread/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.chunk_id = args[0]
        self.inputs = list(args[1:])

    def evaluate(self, sim):
        ids = sim.computes[self.chunk_id](sim).long()
        cols = []
        for nm in self.inputs:
            g = global_input(sim, nm)
            ok = (ids >= 1) & (ids <= len(g))
            cols.append(torch.where(ok, g[torch.clamp(ids, 1, len(g)) - 1],
                                    0.0))
        return cols[0] if len(cols) == 1 else torch.stack(cols, dim=1)


class ComputeGlobalAtom(Compute):
    """compute global/atom index input...: each atom indexes global
    vectors by a per-atom value (src/compute_global_atom.cpp)."""

    style = "global/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.index_in = args[0]
        self.inputs = list(args[1:])

    def evaluate(self, sim):
        idx = peratom_input(sim, self.index_in).long()
        cols = []
        for nm in self.inputs:
            g = global_input(sim, nm)
            ok = (idx >= 1) & (idx <= len(g))
            cols.append(torch.where(ok, g[torch.clamp(idx, 1, len(g)) - 1],
                                    0.0))
        return cols[0] if len(cols) == 1 else torch.stack(cols, dim=1)


class ComputeReduceChunk(Compute):
    """compute reduce/chunk chunkID sum|min|max|ave input...: per-chunk
    reductions of per-atom values (src/compute_reduce_chunk.cpp)."""

    style = "reduce/chunk"
    scalar = False

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.chunk_id = args[0]
        self.mode = args[1]
        if self.mode not in ("sum", "min", "max", "ave"):
            raise NotImplementedError(f"compute reduce/chunk mode "
                                      f"{self.mode!r} is not ported")
        self.inputs = list(args[2:])

    def evaluate(self, sim):
        chunk = sim.computes[self.chunk_id]
        ids = chunk(sim).long()
        n = int(chunk.nchunk)
        valid = (ids >= 1) & (ids <= n)
        ci = ids[valid] - 1
        outs = []
        for nm in self.inputs:
            cv = peratom_input(sim, nm)[valid]
            if self.mode in ("sum", "ave"):
                out = torch.bincount(ci, weights=cv, minlength=n)
                if self.mode == "ave":
                    cnt = torch.bincount(ci, minlength=n)
                    out = out / torch.clamp(cnt, min=1)
            else:
                init = np.inf if self.mode == "min" else -np.inf
                out = torch.full((n,), init, dtype=torch.float64,
                                 device=cv.device).scatter_reduce(
                    0, ci, cv, "amin" if self.mode == "min" else "amax")
            outs.append(out)
        return outs[0] if len(outs) == 1 else torch.stack(outs, dim=1)


def _bond_pairs(sim, sel):
    """(i, j) tag-order index pairs of the bonds whose atoms are both
    selected (the topology's rows name tags; the bonded decks' tags run
    1..natoms)."""
    bonds = sim.topology.get("bond")
    dev = sel.device
    if bonds is None or len(bonds) == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e
    b = torch.as_tensor(np.asarray(bonds)[:, 1:3], dtype=torch.int64,
                        device=dev) - 1
    ok = (b >= 0).all(1) & sel[b[:, 0].clamp(min=0)] & \
        sel[b[:, 1].clamp(min=0)]
    b = b[ok]
    return torch.cat([b[:, 0], b[:, 1]]), torch.cat([b[:, 1], b[:, 0]])


def _clusters(a, sel, i, j):
    big = torch.iinfo(torch.int64).max
    lab = min_label(i, j, torch.where(sel, a.tag.long(), big))
    return torch.where(sel, lab, 0).double()


class ComputeFragmentAtom(Compute):
    """compute fragment/atom: the smallest tag of each atom's
    bond-connected fragment, 0 outside the group
    (src/compute_fragment_atom.cpp)."""

    style = "fragment/atom"
    scalar = False
    peratom = True

    def evaluate(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        return _clusters(a, sel, *_bond_pairs(sim, sel))


class ComputeAggregateAtom(ComputeClusterAtom):
    """compute aggregate/atom cutoff: clusters of atoms joined by a bond
    or by a distance within the cutoff (src/compute_aggregate_atom.cpp)."""

    style = "aggregate/atom"

    def evaluate(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        e = self.edges(sim)
        keep = sel[e.i] & sel[e.j]
        bi, bj = _bond_pairs(sim, sel)
        return _clusters(a, sel, torch.cat([e.i[keep], bi]),
                         torch.cat([e.j[keep], bj]))


STYLES = (ComputePairEnergy, ComputeBondEnergy, ComputeAngleEnergy,
          ComputeDihedralEnergy, ComputeImproperEnergy, ComputeTempRamp,
          ComputeTempProfile, ComputeTempSphere, ComputeTempDeform,
          ComputeERotateSphereAtom,
          ComputeSlice, ComputeReduceRegion, ComputeChunkSpreadAtom,
          ComputeGlobalAtom, ComputeReduceChunk, ComputeFragmentAtom,
          ComputeAggregateAtom)
