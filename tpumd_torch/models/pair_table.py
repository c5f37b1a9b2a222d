"""pair_style table: tabulated pair potentials (src/pair_table.cpp).

PyTorch counterpart of tpumd/models/pair_table.py.  Table files are read
and resampled on the host once, at ``init``, onto N evenly spaced points in
rsq with the reference's natural-spline machinery (spline, splint,
compute_table), so LOOKUP, LINEAR and SPLINE evaluate as the reference
does.  Each sampled point k of every table is one row of a packed device
table holding what the evaluation reads at k (and at k + 1 for SPLINE), so
a force evaluation looks every pair up with one row gather (P1).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows


def _spline(x, y, yp1, ypn):
    """PairTable::spline: natural cubic spline second derivatives."""
    n = len(x)
    y2 = np.zeros(n)
    u = np.zeros(n)
    if yp1 > 0.99e30:
        y2[0] = u[0] = 0.0
    else:
        y2[0] = -0.5
        u[0] = (3.0 / (x[1] - x[0])) * ((y[1] - y[0]) / (x[1] - x[0]) - yp1)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        ui = ((y[i + 1] - y[i]) / (x[i + 1] - x[i])
              - (y[i] - y[i - 1]) / (x[i] - x[i - 1]))
        u[i] = (6.0 * ui / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    if ypn > 0.99e30:
        qn = un = 0.0
    else:
        qn = 0.5
        un = (3.0 / (x[n - 1] - x[n - 2])) * (
            ypn - (y[n - 1] - y[n - 2]) / (x[n - 1] - x[n - 2]))
    y2[n - 1] = (un - qn * u[n - 2]) / (qn * y2[n - 2] + 1.0)
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def _splint(xa, ya, y2a, x):
    khi = np.clip(np.searchsorted(xa, x), 1, len(xa) - 1)
    klo = khi - 1
    h = xa[khi] - xa[klo]
    a = (xa[khi] - x) / h
    b = (x - xa[klo]) / h
    return (a * ya[klo] + b * ya[khi]
            + ((a ** 3 - a) * y2a[klo] + (b ** 3 - b) * y2a[khi])
            * h * h / 6.0)


def read_table_file(path: str, keyword: str):
    """One section of a LAMMPS pair table file: r, e, f and the N, R and
    FPRIME parameters (RSQ tables raise, as in tpumd)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if lines[i].split("#")[0].strip() == keyword:
            break
        i += 1
    else:
        raise ValueError(f"keyword {keyword!r} not found in {path}")
    params = lines[i + 1].split()
    n = int(params[params.index("N") + 1])
    rflag = rlo = rhi = None
    fpflag, fplo, fphi = False, 0.0, 0.0
    if "R" in params:
        k = params.index("R")
        rflag, rlo, rhi = "R", float(params[k + 1]), float(params[k + 2])
    if "RSQ" in params:
        raise NotImplementedError("pair_style table: RSQ tables are not "
                                  "ported (tpumd has none)")
    if "FPRIME" in params:
        k = params.index("FPRIME")
        fpflag, fplo, fphi = True, float(params[k + 1]), float(params[k + 2])
    i += 2
    rows = []
    while len(rows) < n:
        t = lines[i].split()
        if t:
            rows.append([float(t[1]), float(t[2]), float(t[3])])
        i += 1
    arr = np.array(rows)
    return dict(r=arr[:, 0], e=arr[:, 1], f=arr[:, 2], rlo=rlo, rhi=rhi,
                rflag=rflag, fpflag=fpflag, fplo=fplo, fphi=fphi)


@register_pair("table")
class PairTable(PairStyle):
    name = "table"

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        self.tabindex = np.zeros((ntypes + 1, ntypes + 1), dtype=np.int32)
        self.cut = np.zeros((ntypes + 1, ntypes + 1))
        self.tables = []
        self._dev = {}

    def settings(self, style, n, *rest):
        self.tabstyle = str(style)
        if self.tabstyle not in ("lookup", "linear", "spline"):
            raise NotImplementedError(
                f"pair_style table {style} is not ported (lookup, linear, "
                "spline)")
        if rest:
            raise NotImplementedError(f"pair_style table keywords {rest} "
                                      "are not ported")
        self.tablength = int(n)

    def coeff(self, ilo, ihi, jlo, jhi, filename, keyword, *cut):
        tb = read_table_file(str(filename), str(keyword))
        cutoff = float(cut[0]) if cut else (
            tb["rhi"] if tb["rflag"] else tb["r"][-1])
        self.tables.append(self._compute_table(tb, cutoff))
        idx = len(self.tables) - 1
        for i in range(int(ilo), int(ihi) + 1):
            for j in range(max(int(jlo), i), int(jhi) + 1):
                self.tabindex[i, j] = self.tabindex[j, i] = idx
                self.cut[i, j] = self.cut[j, i] = cutoff
                self._setflag[i, j] = self._setflag[j, i] = True
        self._dev = {}

    def _compute_table(self, tb, cutoff):
        """PairTable::compute_table for LOOKUP, LINEAR and SPLINE."""
        r, e, f = tb["r"], tb["e"], tb["f"]
        e2 = _spline(r, e, -f[0], -f[-1])
        if tb["fpflag"]:
            fp0, fpn = tb["fplo"], tb["fphi"]
        else:
            fp0 = (f[1] - f[0]) / (r[1] - r[0])
            fpn = (f[-1] - f[-2]) / (r[-1] - r[-2])
        f2 = _spline(r, f, fp0, fpn)
        tlm1 = self.tablength - 1
        inner = tb["rlo"] if tb["rflag"] else r[0]
        innersq = inner * inner
        delta = (cutoff * cutoff - innersq) / tlm1
        out = dict(innersq=innersq, invdelta=1.0 / delta, cut=cutoff)
        rsq_t = innersq + np.arange(self.tablength) * delta
        rt = np.sqrt(rsq_t)
        et = _splint(r, e, e2, rt)
        ft = _splint(r, f, f2, rt) / rt
        if self.tabstyle == "lookup":
            rm = np.sqrt(innersq + (np.arange(tlm1) + 0.5) * delta)
            out["e"] = _splint(r, e, e2, rm)
            out["f"] = _splint(r, f, f2, rm) / rm
        elif self.tabstyle == "linear":
            out.update(rsq=rsq_t, e=et, f=ft,
                       de=et[1:] - et[:-1], df=ft[1:] - ft[:-1])
        else:  # a spline over the resampled table, in rsq
            out.update(rsq=rsq_t, e=et, f=ft,
                       e2=_spline(rsq_t, et, 1e31, 1e31),
                       f2=_spline(rsq_t, ft, 1e31, 1e31),
                       deltasq6=delta * delta / 6.0)
        return out

    def init(self):
        if not self.tables:
            raise ValueError("pair_style table: no pair_coeff")
        self._dev = {}

    @property
    def max_cutoff(self) -> float:
        return float(self.cut.max())

    def _rows(self, tb):
        """(tlm1, C) what the evaluation reads at sampled point k: LOOKUP
        f e; LINEAR rsq f e df de; SPLINE rsq f e f2 e2 and f e f2 e2 at
        k + 1."""
        tlm1 = self.tablength - 1
        if self.tabstyle == "lookup":
            cols = [tb["f"], tb["e"]]
        elif self.tabstyle == "linear":
            cols = [tb[k][:tlm1] for k in ("rsq", "f", "e")] + \
                [tb["df"], tb["de"]]
        else:
            cols = [tb[k][:tlm1] for k in ("rsq", "f", "e", "f2", "e2")] + \
                [tb[k][1:] for k in ("f", "e", "f2", "e2")]
        return np.stack(cols, axis=1)

    def _device(self, like):
        key = (like.dtype, like.device)
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                       device=like.device)
            tbs = self.tables
            self._dev[key] = (
                t(np.concatenate([self._rows(tb) for tb in tbs])),
                torch.as_tensor(self.tabindex, device=like.device),
                t(self.cut ** 2),
                t([tb["innersq"] for tb in tbs]),
                t([tb["invdelta"] for tb in tbs]),
                t([tb.get("deltasq6", 0.0) for tb in tbs]))
        return self._dev[key]

    def pair_fn(self, r2, itype, jtype):
        rows, tabindex, cutsq_t, innersq_t, invd_t, d6_t = self._device(r2)
        it_l, jt_l = itype.long(), jtype.long()
        tabidx = tabindex[it_l, jt_l].long()
        tlm1 = self.tablength - 1
        innersq = innersq_t[tabidx]
        invd = invd_t[tabidx]
        inside = r2 < cutsq_t[it_l, jt_l]
        k = torch.clamp(((r2 - innersq) * invd).to(torch.int32), 0,
                        tlm1 - 1)
        row = (tabidx * tlm1 + k).to(torch.int32).expand(r2.shape)
        v = torch.unbind(gather_rows(rows, row.contiguous()), dim=-1)
        if self.tabstyle == "lookup":
            fpair, e = v
        elif self.tabstyle == "linear":
            rsq, f0, e0, df, de = v
            frac = (r2 - rsq) * invd
            fpair = f0 + frac * df
            e = e0 + frac * de
        else:
            rsq, f0, e0, f20, e20, f1, e1, f21, e21 = v
            d6 = d6_t[tabidx]
            b = (r2 - rsq) * invd
            a = 1.0 - b
            fpair = (a * f0 + b * f1
                     + ((a ** 3 - a) * f20 + (b ** 3 - b) * f21) * d6)
            e = (a * e0 + b * e1
                 + ((a ** 3 - a) * e20 + (b ** 3 - b) * e21) * d6)
        return (torch.where(inside, fpair, 0.0),
                torch.where(inside, e, 0.0))
