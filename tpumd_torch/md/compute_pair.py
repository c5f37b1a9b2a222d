"""Distance-based and bias computes: rdf, coord/atom, cluster/atom,
displace/atom, group/group, heat/flux, event/displace, temp/com,
temp/partial, temp/region, dipole and dipole/chunk.

The port of tpumd/md/compute_pair.py (src/compute_rdf.cpp,
compute_coord_atom.cpp, compute_cluster_atom.cpp,
compute_displace_atom.cpp, compute_group_group.cpp,
compute_heat_flux.cpp, REPLICA/compute_event_displace.cpp,
compute_temp_com.cpp, compute_temp_partial.cpp, compute_temp_region.cpp,
compute_dipole.cpp, compute_dipole_chunk.cpp).  The distance computes
sweep an occasional neighbor list at their cutoff on the device
(``md/compute_list.py``) where tpumd swept all pairs on the host; each
takes ``plain=True`` to run on the all-pairs plain version instead, the
oracle the tests and the card's check hold it to.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.md import compute_list as cl
from tpumd_torch.md import peratom as pa
from tpumd_torch.md.compute_styles import Compute, RefByTag


class DistanceCompute(Compute):
    """A compute over the pairs within its cutoff."""

    plain = False       # sweep the all-pairs plain version instead

    def list_cutoff(self, sim) -> float:
        raise NotImplementedError

    def edges(self, sim, cutoff=None):
        rc = self.list_cutoff(sim) if cutoff is None else cutoff
        if self.plain:
            return cl.pair_edges_plain(sim, rc)
        return cl.pair_edges(sim, rc)


def pair_cutoff(sim):
    """The pair style's largest cutoff (force->pair->cutforce)."""
    if sim.pair is None:
        raise ValueError("this compute needs a pair style's cutoff")
    return float(sim.pair.max_cutoff)


def _trange(spec, ntypes):
    if spec == "*":
        return 1, ntypes
    if "*" in str(spec):
        lo, hi = str(spec).split("*")
        return (int(lo) if lo else 1), (int(hi) if hi else ntypes)
    return int(spec), int(spec)


class ComputeRDF(DistanceCompute):
    """compute rdf Nbin [itype jtype ...] [cutoff R]: (nbin, 1 + 2 npairs)
    of bin centres, g(r) and coord(r) (src/compute_rdf.cpp:263-396).  Pairs
    whose special weights are both 0 are skipped, as the reference's
    half-list holds them not."""

    style = "rdf"
    scalar = False

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        args = list(args)
        self.cutoff_user = None
        if "cutoff" in args:
            i = args.index("cutoff")
            self.cutoff_user = float(args[i + 1])
            args = args[:i] + args[i + 2:]
        self.nbin = int(args[0])
        rest = args[1:]
        self.typepairs = ([(rest[k], rest[k + 1])
                           for k in range(0, len(rest), 2)]
                          if rest else [("*", "*")])

    def list_cutoff(self, sim):
        return self.cutoff_user or pair_cutoff(sim)

    def _excluded(self, sim, e):
        """(E,) bool: pairs whose lj and coul special weights are both 0."""
        if sim.special_tags is None:
            return None
        wl = np.asarray(sim.special_lj if sim.special_lj is not None
                        else (1.0, 0.0, 0.0, 0.0), np.float64)
        wc = (np.asarray(sim.special_coul, np.float64)
              if sim.special_coul is not None else wl)
        dead = torch.as_tensor((wl == 0.0) & (wc == 0.0), device=e.i.device)
        a = pa.atoms(sim)
        st = torch.as_tensor(np.asarray(sim.special_tags), device=e.i.device)
        sc = torch.as_tensor(np.asarray(sim.special_codes),
                             device=e.i.device).long()
        ti = a.tag[e.i].long() - 1
        hit = (st[ti] == a.tag[e.j][:, None]) & (st[ti] > 0) & dead[sc[ti]]
        return hit.any(1)

    def counts(self, sim):
        """(npairs, nbin) int64 pair counts per bin, the integers that g(r)
        normalizes: the ordered full list gives the reference's half-list
        ipair+jpair tally (compute_rdf.cpp:114-122, 347-356)."""
        a = pa.atoms(sim)
        e = self.edges(sim)
        ing = self.sel(sim)
        ib = (torch.sqrt(e.r2) / (self.list_cutoff(sim) / self.nbin)).long()
        ok = (ib < self.nbin) & ing[e.i] & ing[e.j]
        ex = self._excluded(sim, e)
        if ex is not None:
            ok &= ~ex
        ti, tj = a.type[e.i], a.type[e.j]
        out = []
        for p, q in self.typepairs:
            (il, ih), (jl, jh) = (_trange(p, sim.ntypes),
                                  _trange(q, sim.ntypes))
            m = ok & (ti >= il) & (ti <= ih) & (tj >= jl) & (tj <= jh)
            out.append(torch.bincount(ib[m], minlength=self.nbin))
        return torch.stack(out)

    def evaluate(self, sim):
        a = pa.atoms(sim)
        delr = self.list_cutoff(sim) / self.nbin
        nt = sim.ntypes
        pairs = [(_trange(p, nt), _trange(q, nt)) for p, q in self.typepairs]
        hist = self.counts(sim).cpu().numpy().astype(np.float64)
        typ = a.type.cpu().numpy()
        ingh = self.sel(sim).cpu().numpy()
        vol = float(a.lengths.prod())
        const = 4.0 * np.pi / (3.0 * vol)
        out = np.zeros((self.nbin, 1 + 2 * len(pairs)))
        out[:, 0] = (np.arange(self.nbin) + 0.5) * delr
        tcount = np.array([((typ == t) & ingh).sum() for t in range(nt + 1)])
        for m, ((il, ih), (jl, jh)) in enumerate(pairs):
            icount = tcount[il:ih + 1].sum()
            jcount = tcount[jl:jh + 1].sum()
            dup = sum(tcount[t] for t in range(il, ih + 1) if jl <= t <= jh)
            normfac = (jcount - dup / icount) if icount > 0 else 0.0
            ncoord = 0.0
            for b in range(self.nbin):
                rlo, rhi = b * delr, (b + 1) * delr
                vfrac = const * (rhi ** 3 - rlo ** 3)
                gr = (hist[m, b] / (vfrac * normfac * icount)
                      if vfrac * normfac != 0.0 else 0.0)
                if icount:
                    ncoord += gr * vfrac * normfac
                out[b, 1 + 2 * m] = gr
                out[b, 2 + 2 * m] = ncoord
        return torch.as_tensor(out, device=a.x.device)


class ComputeCoordAtom(DistanceCompute):
    """compute coord/atom cutoff R [type ...]: neighbours within R per atom
    (src/compute_coord_atom.cpp, CUTOFF style)."""

    style = "coord/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        args = list(args)
        if args and args[0] == "cutoff":
            args = args[1:]
        self.cutoff = float(args[0])
        self.typespecs = args[1:]
        if any(t.startswith("group") for t in self.typespecs):
            raise NotImplementedError("compute coord/atom group keyword is "
                                      "not ported (tpumd lacks it)")

    def list_cutoff(self, sim):
        return self.cutoff

    def evaluate(self, sim):
        a = pa.atoms(sim)
        e = self.edges(sim)
        cols = []
        for spec in self.typespecs or ["*"]:
            m = (torch.ones_like(e.i, dtype=torch.bool) if spec == "*"
                 else a.type[e.j] == int(spec))
            cols.append(torch.bincount(e.i[m], minlength=a.n).double())
        out = torch.stack(cols, dim=1)
        out = torch.where(self.sel(sim)[:, None], out, 0.0)
        return out[:, 0] if out.shape[1] == 1 else out


def min_label(i, j, label):
    """Each atom's smallest label over its connected component of the pairs
    (i, j), by propagating minima over the pairs until nothing changes
    (LAMMPS's loop, compute_cluster_atom.cpp)."""
    lab = label.clone()
    while True:
        new = lab.scatter_reduce(0, i, lab[j], "amin")
        if torch.equal(new, lab):
            return lab
        lab = new


class ComputeClusterAtom(DistanceCompute):
    """compute cluster/atom cutoff: the smallest tag of each atom's cluster
    (src/compute_cluster_atom.cpp); 0 outside the group."""

    style = "cluster/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.cutoff = float(args[0])

    def list_cutoff(self, sim):
        return self.cutoff

    def evaluate(self, sim):
        a = pa.atoms(sim)
        e = self.edges(sim)
        ing = self.sel(sim)
        keep = ing[e.i] & ing[e.j]
        big = torch.iinfo(torch.int64).max
        lab = torch.where(ing, a.tag.long(), big)
        lab = min_label(e.i[keep], e.j[keep], lab)
        return torch.where(ing, lab, 0).double()


class ComputeDisplaceAtom(Compute):
    """compute displace/atom: dx dy dz |d| of the unwrapped positions from
    those at the first set-up (src/compute_displace_atom.cpp)."""

    style = "displace/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.ref = RefByTag()

    def setup(self, sim):
        a = pa.atoms(sim)
        self.ref.take(a.tag, a.xu)

    def evaluate(self, sim):
        a = pa.atoms(sim)
        d = a.xu - self.ref.of(a.tag, a.xu)
        return torch.cat([d, torch.linalg.norm(d, dim=1)[:, None]], dim=1)


class ComputeGroupGroup(DistanceCompute):
    """compute group/group group2: scalar = the pair energy between the
    compute's group and group2, vector = the force on the compute's group
    (src/compute_group_group.cpp's pair term; tpumd's, without kspace and
    with no special weights)."""

    style = "group/group"
    extensive = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.group2 = args[0]
        if len(args) > 1:
            raise NotImplementedError(
                f"compute group/group keywords {list(args[1:])} are not "
                "ported (tpumd takes none)")

    def list_cutoff(self, sim):
        return pair_cutoff(sim)

    def _terms(self, sim):
        a = pa.atoms(sim)
        e = self.edges(sim)
        if self.group2 not in sim.groups:
            raise ValueError(f"undefined group {self.group2!r}")
        sel2 = pa.group_sel(sim, self.group2)
        m = self.sel(sim)[e.i] & sel2[e.j]
        i, j, d, r2 = e.i[m], e.j[m], e.d[m], e.r2[m]
        ti, tj = a.type[i], a.type[j]
        pair = sim.pair
        ex = getattr(pair, "pair_fn_ex", None)
        if ex is not None:
            one = torch.ones_like(r2)
            q = a.q if a.q is not None else torch.zeros_like(r2[:0])
            fpair, en, ec, fcoul = ex(r2, ti, tj, one, one, q[i], q[j])
        else:
            fpair, en = pair.pair_fn(r2, ti, tj)
            ec = fcoul = None
        if fcoul is not None:
            fpair = fpair + fcoul
        if ec is not None:
            en = en + ec
        return en.sum(), (fpair[:, None] * d).sum(0)

    def evaluate(self, sim):
        return self._terms(sim)[0]

    def vector_value(self, sim):
        return pa.cached(sim, ("gg vector", id(self)),
                         lambda: self._terms(sim)[1])


class ComputeHeatFlux(Compute):
    """compute heat/flux ke-ID pe-ID stress-ID: Jx Jy Jz and the convective
    part Jcx Jcy Jcz, not volume-normalized
    (src/compute_heat_flux.cpp:97-180)."""

    style = "heat/flux"
    scalar = False
    extensive = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.ids = list(args[:3])

    def evaluate(self, sim):
        ke, pe, st = (sim.computes[c](sim) for c in self.ids)
        a = pa.atoms(sim)
        sel = self.sel(sim)
        eng = torch.where(sel, ke + pe, 0.0)
        vv = torch.where(sel[:, None], a.v, 0.0)
        ss = st
        jc = (eng[:, None] * vv).sum(0)
        jv = -torch.stack([
            ss[:, 0] * vv[:, 0] + ss[:, 3] * vv[:, 1] + ss[:, 4] * vv[:, 2],
            ss[:, 3] * vv[:, 0] + ss[:, 1] * vv[:, 1] + ss[:, 5] * vv[:, 2],
            ss[:, 4] * vv[:, 0] + ss[:, 5] * vv[:, 1] + ss[:, 2] * vv[:, 2],
        ], dim=1).sum(0) / sim.units.nktv2p
        return torch.cat([jc + jv, jc])


class ComputeEventDisplace(Compute):
    """compute event/displace Dcut (src/REPLICA/
    compute_event_displace.cpp): 1 where some atom moved more than Dcut
    since the last stored event, else 0.  The prd, tad and hyper commands
    bind its event store (``detector``, md/prd.py::EventDetector) and drive
    the comparison themselves; unbound, or before the first event is
    stored, it is 0, as in tpumd."""

    style = "event/displace"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        dist = float(args[0])
        if dist <= 0.0:
            raise ValueError(
                "Distance must be > 0 for compute event/displace")
        self.displace_dist = dist
        self.detector = None

    def evaluate(self, sim):
        hit = (self.detector is not None and self.detector.xevent is not None
               and self.detector.check(sim, sim._carry))
        return torch.tensor(float(hit), dtype=torch.float64,
                            device=pa.atoms(sim).x.device)


class ComputeDipole(Compute):
    """compute dipole [geometry|mass]: the group's dipole moment about its
    (mass or geometric) centre, and its norm (src/compute_dipole.cpp);
    c_ID alone is the norm."""

    style = "dipole"
    scalar = False

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.usecenter = "mass" if not args else str(args[0])

    def _weights(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        m = a.mass if self.usecenter == "mass" else torch.ones_like(a.mass)
        q = a.q if a.q is not None else torch.zeros_like(a.mass)
        return a, torch.where(sel, m, 0.0), torch.where(sel, q, 0.0)

    def evaluate(self, sim):
        a, m, q = self._weights(sim)
        com = (a.xu * m[:, None]).sum(0) / torch.clamp(m.sum(), min=1e-300)
        mu = (a.xu * q[:, None]).sum(0) - q.sum() * com
        return torch.cat([mu, torch.sqrt((mu * mu).sum())[None]])

    def scalar_value(self, sim):
        return self(sim)[3]


class ComputeDipoleChunk(ComputeDipole):
    """compute dipole/chunk chunkID [geometry|mass]
    (src/compute_dipole_chunk.cpp): each chunk's dipole vector and norm."""

    style = "dipole/chunk"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args[1:])
        self.chunkid = str(args[0])

    def evaluate(self, sim):
        from tpumd_torch.md.compute_chunk import chunk_ids, chunk_sum
        a, m, q = self._weights(sim)
        idx, n = chunk_ids(sim, self.chunkid)
        mt = chunk_sum(n, idx, m)
        com = chunk_sum(n, idx, a.xu * m[:, None]) \
            / torch.clamp(mt, min=1e-300)[:, None]
        mu = chunk_sum(n, idx, a.xu * q[:, None]) \
            - chunk_sum(n, idx, q)[:, None] * com
        return torch.cat([mu, torch.sqrt((mu * mu).sum(1))[:, None]], dim=1)

    def scalar_value(self, sim):
        raise ValueError(f"compute {self.id} (dipole/chunk) has no scalar")


def fix_dof(sim):
    return sum(fx.dof_removed for fx in sim.fixes)


def bias_temp(sim, ke, dof):
    u = sim.units
    return u.mvv2e * ke / max(dof, 1) / u.boltz


class ComputeTempCOM(Compute):
    """compute temp/com: the group's temperature with its centre-of-mass
    velocity removed (src/compute_temp_com.cpp)."""

    style = "temp/com"

    def evaluate(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        ms = torch.where(sel, a.mass, 0.0)
        vcm = (a.v * ms[:, None]).sum(0) / torch.clamp(ms.sum(), min=1e-300)
        vt = a.v - vcm
        n = int(sel.sum())
        dof = sim.dimension * n - sim.dimension - fix_dof(sim)
        return bias_temp(sim, (ms * (vt * vt).sum(1)).sum(), dof)


class ComputeTempPartial(Compute):
    """compute temp/partial xflag yflag zflag
    (src/compute_temp_partial.cpp)."""

    style = "temp/partial"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.flags = [int(v) for v in args[:3]]

    def evaluate(self, sim):
        a = pa.atoms(sim)
        sel = self.sel(sim)
        ms = torch.where(sel, a.mass, 0.0)
        n = int(sel.sum())
        nper = sum(self.flags)
        dof = nper * n - (nper / sim.dimension) * (fix_dof(sim)
                                                   + sim.dimension)
        flags = torch.tensor(self.flags, dtype=torch.float64,
                             device=a.x.device)
        ke = (ms * ((a.v * flags) * a.v).sum(1)).sum()
        u = sim.units
        return u.mvv2e * ke / max(dof, 1e-300) / u.boltz


class ComputeTempRegion(Compute):
    """compute temp/region regionID (src/compute_temp_region.cpp): the
    temperature of the group's atoms inside the region, dof = dim count -
    dim."""

    style = "temp/region"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.region = str(args[0])

    def evaluate(self, sim):
        a = pa.atoms(sim)
        reg = sim.script.regions[self.region]
        inside = torch.as_tensor(reg.inside(a.x.cpu().numpy()),
                                 device=a.x.device) & self.sel(sim)
        n = int(inside.sum())
        dof = sim.dimension * n - sim.dimension
        ke = (torch.where(inside, a.mass, 0.0) * (a.v * a.v).sum(1)).sum()
        return bias_temp(sim, ke, dof)


STYLES = (ComputeRDF, ComputeCoordAtom, ComputeClusterAtom,
          ComputeDisplaceAtom, ComputeGroupGroup, ComputeHeatFlux,
          ComputeEventDisplace, ComputeDipole, ComputeDipoleChunk,
          ComputeTempCOM, ComputeTempPartial, ComputeTempRegion)
