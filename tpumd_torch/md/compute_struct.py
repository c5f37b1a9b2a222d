"""Structure-identification per-atom computes: cna/atom, centro/atom and
orientorder/atom, on the device.

The port of tpumd/md/compute_struct.py (src/compute_cna_atom.cpp: the
FCC/HCP/BCC/ICOS common-neighbour signatures; src/compute_centro_atom.cpp:
Kelchner centrosymmetry over the nnn nearest; src/compute_orientorder_atom.
cpp: Steinhardt Q_l).  tpumd built a dense N x N adjacency on the host;
here each compute reads the occasional neighbor list at its cutoff
(``md/compute_list.py``), pads every atom's neighbours into a table and
works on the whole table at once:

- cna/atom keeps each atom's first MAXNEAR neighbours in tag order (as
  tpumd's nears), finds each neighbour pair's common neighbours (the first
  MAXCOMMON, in tag order) by comparing the two rows, and reads the bonds
  among them from the adjacency, by distance, among the atom's
  neighbours;
- centro/atom and orientorder/atom pick the nnn nearest with
  ``torch.topk``; orientorder evaluates Y_lm by the normalized associated
  Legendre recurrence (tpumd called scipy's sph_harm_y).

Results are in tag order.  cna's codes: 0 outside the group, 1 fcc, 2
hcp, 3 bcc, 4 icosahedral, 5 other (also an atom with neither 12 nor 14
neighbours).  ``plain = True`` runs a compute on the all-pairs plain
version of the list.
"""

from __future__ import annotations

import math

import torch

from tpumd_torch.md import compute_list as cl
from tpumd_torch.md import peratom as pa
from tpumd_torch.md.compute_pair import DistanceCompute, pair_cutoff

MAXNEAR = 16      # src/compute_cna_atom.cpp:36
MAXCOMMON = 8


def _r2(d):
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2]


class ComputeCNAAtom(DistanceCompute):
    """compute ID group cna/atom cutoff."""

    style = "cna/atom"
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
        dev = a.x.device
        near, count, _ = cl.neighbor_table(e, MAXNEAR)
        nnear = torch.clamp(count, max=MAXNEAR)
        insel = self.sel(sim)
        out = torch.where(insel, 5.0, 0.0).to(torch.float64)
        atoms_ = torch.nonzero(insel & ((nnear == 12) | (nnear == 14))
                               ).flatten()
        if atoms_.numel() == 0:
            return out
        k = torch.arange(MAXNEAR, device=dev)
        ni = near[atoms_]                                  # (S, 16)
        okk = k[None, :] < nnear[atoms_][:, None]          # (S, 16)
        nj = near[torch.clamp(ni, min=0)]                  # (S, 16, 16)
        # common[s, jj, kk]: neighbour kk of i is a neighbour of i's jj-th
        common = ((ni[:, None, :, None] == nj[:, :, None, :])
                  & (nj >= 0)[:, :, None, :]).any(-1)
        common &= okk[:, None, :] & okk[:, :, None]
        take = common & (torch.cumsum(common.to(torch.int64), -1)
                         <= MAXCOMMON)
        pos = torch.argsort(torch.where(take, k, MAXNEAR + k), dim=-1,
                            stable=True)[..., :MAXCOMMON]
        cok = torch.gather(take, -1, pos)                  # (S, 16, 8)
        # the common neighbours are i's neighbours: their bonds are read
        # from the adjacency among i's neighbours, by distance as tpumd's
        # adjacency has them
        xn = a.x[torch.clamp(ni, min=0)]                   # (S, 16, 3)
        r2 = _r2(pa.min_image(xn[:, :, None, :] - xn[:, None, :, :], a))
        eye = torch.eye(MAXNEAR, dtype=torch.bool, device=dev)
        adj = (r2 < self.cutoff * self.cutoff) & ~eye      # (S, 16, 16)
        rows_ = torch.gather(adj[:, None].expand(-1, MAXNEAR, -1, -1), 2,
                             pos[..., None].expand(-1, -1, -1, MAXNEAR))
        bond = torch.gather(rows_, 3, pos[:, :, None, :].expand(
            -1, -1, MAXCOMMON, -1))                        # (S, 16, 8, 8)
        bond &= cok[..., :, None] & cok[..., None, :]
        bonds = bond.sum(-1)                               # (S, 16, 8)
        nc = cok.sum(-1)
        nb = bonds.sum(-1) // 2
        mx = torch.where(cok, bonds, -1).amax(-1)
        mn = torch.where(cok, bonds, MAXCOMMON + 1).amin(-1)
        mx = torch.where(nc > 0, mx, 0)
        mn = torch.where(nc > 0, mn, MAXCOMMON)

        def nsig(c, b, hi, lo):
            return ((nc == c) & (nb == b) & (mx == hi) & (mn == lo)
                    & okk).sum(-1)
        n12 = nnear[atoms_] == 12
        nfcc, nhcp, nico = nsig(4, 2, 1, 1), nsig(4, 2, 2, 0), \
            nsig(5, 5, 2, 2)
        bcc = (nsig(4, 4, 2, 2) == 6) & (nsig(6, 6, 2, 2) == 8)
        pat = torch.full_like(nfcc, 5)
        pat = torch.where(n12 & (nico == 12), 4, pat)
        pat = torch.where(n12 & (nfcc == 6) & (nhcp == 6), 2, pat)
        pat = torch.where(n12 & (nfcc == 12), 1, pat)
        pat = torch.where(~n12 & bcc, 3, pat)
        out[atoms_] = pat.to(torch.float64)
        return out


def _nearest(e, nnn):
    """(rows (S,) with at least nnn neighbours, rv (S, nnn, 3) x_j - x_i of
    their nnn nearest) from the Edges e."""
    table, count, col = cl.neighbor_table(e)
    w = table.shape[1]
    r2t = torch.full((e.n, w), math.inf, dtype=torch.float64,
                     device=e.i.device)
    r2t[e.i, col] = e.r2
    dt = torch.zeros((e.n, w, 3), dtype=torch.float64, device=e.i.device)
    dt[e.i, col] = -e.d
    rows = torch.nonzero(count >= nnn).flatten()
    pick = torch.topk(r2t[rows], nnn, dim=1, largest=False).indices
    rv = torch.gather(dt[rows], 1, pick[..., None].expand(-1, -1, 3))
    return rows, rv


class ComputeCentroAtom(DistanceCompute):
    """compute ID group centro/atom fcc|bcc|N: the sum of the nnn/2
    smallest |R_j + R_k|^2 over pairs of the nnn nearest neighbours within
    the pair cutoff (0 with fewer)."""

    style = "centro/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        lattice = args[0] if args else "fcc"
        self.nnn = {"fcc": 12, "bcc": 8}.get(lattice)
        if self.nnn is None:
            self.nnn = int(lattice)
        if self.nnn % 2 or self.nnn <= 0:
            raise ValueError("centro/atom N must be positive and even")
        if len(args) > 1:
            raise NotImplementedError(
                f"compute centro/atom keywords {list(args[1:])} are not "
                "ported (tpumd takes none)")

    def list_cutoff(self, sim):
        return pair_cutoff(sim)

    def evaluate(self, sim):
        a = pa.atoms(sim)
        out = torch.zeros(a.n, dtype=torch.float64, device=a.x.device)
        rows, rv = _nearest(self.edges(sim), self.nnn)
        jj, kk = torch.triu_indices(self.nnn, self.nnn, 1,
                                    device=a.x.device)
        p2 = _r2(rv[:, jj] + rv[:, kk])
        cs = torch.sort(p2, dim=1).values[:, :self.nnn // 2].sum(1)
        out[rows] = cs
        return torch.where(self.sel(sim), out, 0.0)


def ylm_table(x, lmax):
    """{(l, m): y_lm(x)} for 0 <= m <= l <= lmax: the normalized associated
    Legendre functions sqrt((2l+1)/4pi (l-m)!/(l+m)!) P_l^m(x), with the
    Condon-Shortley phase, by the stable recurrences in m then l."""
    s = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    y = {(0, 0): torch.full_like(x, 1.0 / math.sqrt(4.0 * math.pi))}
    for m in range(1, lmax + 1):
        y[m, m] = -math.sqrt((2 * m + 1) / (2.0 * m)) * s * y[m - 1, m - 1]
    for m in range(0, lmax):
        y[m + 1, m] = math.sqrt(2 * m + 3) * x * y[m, m]
        for l in range(m + 2, lmax + 1):
            al = math.sqrt((4 * l * l - 1) / (l * l - m * m))
            bl = math.sqrt(((l - 1) ** 2 - m * m) / (4 * (l - 1) ** 2 - 1))
            y[l, m] = al * (x * y[l - 1, m] - bl * y[l - 2, m])
    return y


class ComputeOrientOrderAtom(DistanceCompute):
    """compute ID group orientorder/atom [nnn N|NULL] [degrees k l1..lk]
    [cutoff R]: per-atom Steinhardt Q_l columns (tpumd takes no wl, wl/hat
    or components)."""

    style = "orientorder/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.nnn = 12
        self.qlist = (4, 6, 8, 10, 12)
        self.cutoff_user = None
        args = list(args)
        i = 0
        while i < len(args):
            k = args[i]
            if k == "nnn":
                self.nnn = None if args[i + 1] == "NULL" else int(args[i + 1])
                i += 2
            elif k == "degrees":
                nq = int(args[i + 1])
                self.qlist = tuple(int(v) for v in args[i + 2:i + 2 + nq])
                i += 2 + nq
            elif k == "cutoff":
                self.cutoff_user = float(args[i + 1])
                i += 2
            else:
                raise NotImplementedError(
                    f"orientorder/atom keyword {k!r} is not ported (tpumd "
                    "takes nnn, degrees and cutoff)")

    def list_cutoff(self, sim):
        return self.cutoff_user or pair_cutoff(sim)

    def evaluate(self, sim):
        a = pa.atoms(sim)
        e = self.edges(sim)
        dev = a.x.device
        out = torch.zeros((a.n, len(self.qlist)), dtype=torch.float64,
                          device=dev)
        if self.nnn is not None:
            rows, rv = _nearest(e, self.nnn)
            w = torch.ones(rv.shape[:2], dtype=torch.float64, device=dev)
        else:
            table, count, col = cl.neighbor_table(e)
            rows = torch.nonzero(count > 0).flatten()
            dt = torch.zeros(table.shape + (3,), dtype=torch.float64,
                             device=dev)
            dt[e.i, col] = -e.d
            rv = dt[rows]
            w = (table[rows] >= 0).to(torch.float64)
        if rows.numel():
            rmag = torch.sqrt(_r2(rv))
            rmag = torch.where(w > 0, rmag, 1.0)
            cth = torch.clamp(rv[..., 2] / rmag, -1.0, 1.0)
            phi = torch.atan2(rv[..., 1], rv[..., 0])
            y = ylm_table(cth, max(self.qlist))
            nn = w.sum(1)
            for il, l in enumerate(self.qlist):
                qsum = 0.0
                for m in range(l + 1):
                    re = (w * y[l, m] * torch.cos(m * phi)).sum(1) / nn
                    im = (w * y[l, m] * torch.sin(m * phi)).sum(1) / nn
                    qsum = qsum + (1.0 if m == 0 else 2.0) * (re * re
                                                              + im * im)
                out[rows, il] = torch.sqrt(4.0 * math.pi / (2 * l + 1)
                                           * qsum)
        return torch.where(self.sel(sim)[:, None], out, 0.0)


STYLES = (ComputeCNAAtom, ComputeCentroAtom, ComputeOrientOrderAtom)
