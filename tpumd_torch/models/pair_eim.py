"""pair_style eim: the embedded-ion method for ionic compounds
(src/MANYBODY/pair_eim.cpp), the port's copy of tpumd/models/pair_eim.py,
on the matrix engine.

Three passes over the full neighbor rows: the charges rho_i = sum_j
sigma_ij(r), the potentials fp_i = sum_j rho_j coul_ij(r), then
E = sum_i 1/2 rho_i fp_i + 1/2 sum_ij [phi_ij(r) - q0_i q0_j coul_ij(r)]
with the reference's pair force psip = phi' + (rho_i rho_j - q0_i q0_j)
coul' + fp_i sigma'_ji + fp_j sigma'_ij (pair_eim.cpp:254-300).  The
ffield's analytic forms are sampled on an nr = 5000 grid and read through
EAM's cubic splines, as the reference does (read_file, funcphi,
funcsigma, funccoul).  Every spline row and the neighbours' rows, rho and
fp are row gathers (P1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpumd_torch.models.pair_eam import PairEAM, _interpolate
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows


def _parse_ffield(path: str):
    """The global:, element: and pair: records ('&' joins continuations)."""
    lines = []
    with open(path) as fh:
        buf = ""
        for raw in fh:
            raw = raw.split("###")[0].rstrip()
            if not raw.strip():
                continue
            buf += " " + raw
            if buf.rstrip().endswith("&"):
                buf = buf.rstrip()[:-1]
                continue
            lines.append(buf.strip())
            buf = ""
    glob = None
    elements = {}
    pairs = {}
    for ln in lines:
        toks = ln.split()
        if toks[0] == "global:":
            glob = dict(division=float(toks[1]), rbig=float(toks[2]),
                        rsmall=float(toks[3]))
        elif toks[0] == "element:":
            elements[toks[1]] = dict(
                ielement=int(toks[2]), mass=float(toks[3]),
                negativity=float(toks[4]), ra=float(toks[5]),
                ri=float(toks[6]), Ec=float(toks[7]), q0=float(toks[8]))
        elif toks[0] == "pair:":
            key = tuple(sorted((toks[1], toks[2])))
            v = [float(t) for t in toks[3:17]]
            pairs[key] = dict(
                rcutphiA=v[0], rcutphiR=v[1], Eb=v[2], r0=v[3],
                alpha=v[4], beta=v[5], rcutq=v[6], Asigma=v[7],
                rq=v[8], rcutsigma=v[9], Ac=v[10], zeta=v[11],
                rs=v[12], tp=int(v[13]))
    if glob is None:
        raise ValueError("Missing global line in EIM potential file")
    return glob, elements, pairs


@register_pair("eim")
class PairEIM(PairEAM):
    """The spline helpers are EAM's; the tables are EIM's own."""

    name = "eim"
    supports_cellgrid = False

    def settings(self, *args):
        if args:
            raise ValueError("pair_style eim takes no arguments")

    def coeff(self, ilo, ihi, jlo, jhi, *args):
        # pair_coeff * * <elements in the file> ffield.eim El1 El2 ...: the
        # leading names choose the file's entries, the trailing ones map
        # the atom types
        args = [str(a) for a in args]
        fi = next(i for i, a in enumerate(args) if a.endswith(".eim")
                  or "/" in a)
        filename = args[fi]
        type_elems = args[fi + 1:]
        if len(type_elems) != self.ntypes:
            raise ValueError("eim: need one element name per atom type")
        self._glob, self._elements, self._pairs = _parse_ffield(filename)
        self._elnames = list(args[:fi])
        self._typemap = np.zeros(self.ntypes + 1, dtype=np.int32)
        for t, e in enumerate(type_elems, start=1):
            if e not in self._elnames:
                raise ValueError(f"eim: element {e} not in pair_coeff list")
            self._typemap[t] = self._elnames.index(e)
            self.mass[t] = self._elements[e]["mass"]
            self._setflag[t, t] = True

    # the reference's analytic forms (pair_eim.cpp:821-910)
    def _pairkey(self, i, j):
        return tuple(sorted((self._elnames[i], self._elnames[j])))

    def _funccutoff(self, rp, rc, r):
        g = self._glob
        a = (g["rsmall"] - g["rbig"]) / (rc - rp) * (r - rp) + g["rbig"]
        return ((math.erfc(a) - math.erfc(g["rsmall"]))
                / (math.erfc(g["rbig"]) - math.erfc(g["rsmall"])))

    def _funcphi(self, i, j, r):
        p = self._pairs[self._pairkey(i, j)]
        r = max(r, 0.2)
        value = 0.0
        if p["tp"] == 1:
            a = p["Eb"] * p["alpha"] / (p["beta"] - p["alpha"])
            b = p["Eb"] * p["beta"] / (p["beta"] - p["alpha"])
            if r < p["rcutphiA"]:
                value -= a * math.exp(-p["beta"] * (r / p["r0"] - 1.0)) \
                    * self._funccutoff(p["r0"], p["rcutphiA"], r)
            if r < p["rcutphiR"]:
                value += b * math.exp(-p["alpha"] * (r / p["r0"] - 1.0)) \
                    * self._funccutoff(p["r0"], p["rcutphiR"], r)
        elif p["tp"] == 2:
            a = (p["Eb"] * p["alpha"] * p["r0"] ** p["beta"]
                 / (p["beta"] - p["alpha"]))
            b = (a * p["beta"] / p["alpha"]
                 * p["r0"] ** (p["alpha"] - p["beta"]))
            if r < p["rcutphiA"]:
                value -= a / r ** p["beta"] \
                    * self._funccutoff(p["r0"], p["rcutphiA"], r)
            if r < p["rcutphiR"]:
                value += b / r ** p["alpha"] \
                    * self._funccutoff(p["r0"], p["rcutphiR"], r)
        return value

    def _funcsigma(self, i, j, r):
        p = self._pairs[self._pairkey(i, j)]
        r = max(r, 0.2)
        if r >= p["rcutq"]:
            return 0.0
        ni = self._elements[self._elnames[i]]["negativity"]
        nj = self._elements[self._elnames[j]]["negativity"]
        return p["Asigma"] * (nj - ni) \
            * self._funccutoff(p["rq"], p["rcutq"], r)

    def _funccoul(self, i, j, r):
        p = self._pairs[self._pairkey(i, j)]
        r = max(r, 0.2)
        if r >= p["rcutsigma"]:
            return 0.0
        return p["Ac"] * math.exp(-p["zeta"] * r) \
            * self._funccutoff(p["rs"], p["rcutsigma"], r)

    def init(self):
        ne = len(self._elnames)
        nt = self.ntypes
        self.nr = 5000
        cuts = np.zeros((ne, ne))
        for i in range(ne):
            for j in range(i, ne):
                p = self._pairs[self._pairkey(i, j)]
                cuts[i, j] = cuts[j, i] = max(
                    p["rcutphiA"], p["rcutphiR"], p["rcutq"],
                    p["rcutsigma"])
        cut = float(cuts.max())
        self.dr = cut / (self.nr - 1.0)
        self.cutmax = cut
        tm = self._typemap
        self.cutforcesq = np.zeros((nt + 1, nt + 1))
        for a in range(1, nt + 1):
            for b in range(1, nt + 1):
                self.cutforcesq[a, b] = cuts[tm[a], tm[b]] ** 2
        rgrid = np.arange(self.nr) * self.dr

        # sampled as read_file does: value[k+1] = func(k dr)
        def tab(func, i, j):
            col = np.zeros(self.nr + 1)
            col[1:] = [func(i, j, r) for r in rgrid]
            return _interpolate(self.nr, self.dr, col)

        self.Fij_spline = np.stack(
            [tab(self._funcsigma, i, j)
             for i in range(ne) for j in range(ne)])
        tri = [(i, j) for i in range(ne) for j in range(i + 1)]
        self.Gij_spline = np.stack(
            [tab(self._funccoul, i, j) for (i, j) in tri])
        self.phiij_spline = np.stack(
            [tab(self._funcphi, i, j) for (i, j) in tri])
        trimap = {ij: n for n, ij in enumerate(tri)}
        self.type2Fij = np.zeros((nt + 1, nt + 1), dtype=np.int32)
        self.type2Gij = np.zeros_like(self.type2Fij)
        for a in range(1, nt + 1):
            for b in range(1, nt + 1):
                self.type2Fij[a, b] = tm[a] * ne + tm[b]
                key = (max(tm[a], tm[b]), min(tm[a], tm[b]))
                self.type2Gij[a, b] = trimap[key]
        self.q0 = np.zeros(nt + 1)
        for a in range(1, nt + 1):
            self.q0[a] = self._elements[self._elnames[tm[a]]]["q0"]
        self._tables = {}

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag: bool, vflag: bool, q=None, ext=None):
        if ext is not None:
            raise NotImplementedError(
                "pair_style eim: a box narrower than 2*cutneigh (the "
                "multi-image mode) is not ported")
        cutsq = self._tables.get("cutsq")
        if cutsq is None or cutsq.device != x.device \
                or cutsq.dtype != x.dtype:
            cutsq = self._tables["cutsq"] = torch.as_tensor(
                self.cutforcesq, dtype=x.dtype, device=x.device)
        d, r, inside, m, p, it, jt = self._pass_geometry(x, type_, box, idx,
                                                         cutsq)
        t2F = self._index_table("type2Fij", x)
        t2G = self._index_table("type2Gij", x)
        nr = self.nr
        ins = inside.to(x.dtype)
        cF_ij = self._rows("Fij", t2F[it, jt], m, x, nr)
        rho = torch.sum(self._val(cF_ij, p) * ins, dim=1)
        cG = self._rows("Gij", t2G[it, jt], m, x, nr)
        rhoj = gather_rows(rho[:, None].contiguous(), idx)[..., 0]
        fp = torch.sum(self._val(cG, p) * ins * rhoj, dim=1)
        cF_ji = self._rows("Fij", t2F[jt, it], m, x, nr)
        rhoip, rhojp = self._der(cF_ji, p), self._der(cF_ij, p)
        cP = self._rows("phiij", t2G[it, jt], m, x, nr)
        phip, phi = self._der(cP, p), self._val(cP, p)
        coul, coulp = self._val(cG, p), self._der(cG, p)
        q0 = self._tables.get(("q0", x.device, x.dtype))
        if q0 is None:
            q0 = self._tables[("q0", x.device, x.dtype)] = torch.as_tensor(
                self.q0, dtype=x.dtype, device=x.device)
        q0q0 = q0[it] * q0[jt]
        fpj = gather_rows(fp[:, None].contiguous(), idx)[..., 0]
        psip = (phip + (rho[:, None] * rhoj - q0q0) * coulp
                + fp[:, None] * rhojp + fpj * rhoip)
        fpair = torch.where(inside, -psip / r, 0.0)
        fpw = d * fpair[..., None]
        f = torch.sum(fpw, dim=1)
        evdwl = None
        if eflag:
            e_embed = torch.sum(torch.where(type_ > 0, 0.5 * rho * fp, 0.0))
            epair = torch.where(inside, phi - q0q0 * coul, 0.0)
            evdwl = e_embed + 0.5 * torch.sum(epair)
        return f, evdwl, None, (self._virial(fpw, d) if vflag else None)
