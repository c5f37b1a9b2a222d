"""Tabulated bonded styles: bond_style table and angle_style table
(src/MOLECULE/bond_table.cpp, angle_table.cpp), the port's copy of
tpumd/models/bonded_table.py with its own table-file reader.

The reference's pipeline: the file's points are splined (natural spline
with force-derived end slopes), resampled to ``tablength`` uniform bins (in
r for bonds, in [0, pi] for angles), then read per evaluation as
``linear`` (value + fraction * delta) or ``spline`` (cubic with the
resampled second derivatives).  The uniform grid turns a search into one
multiply; each column is one gather of a flat (type, bin) table.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.bonded import AngleStyle, BondStyle, \
    angle_geometry
from tpumd_torch.models.pair_table import _spline, _splint
from tpumd_torch.models.registry import register_bonded

DEG2RAD = np.pi / 180.0


def read_bonded_table(path, keyword):
    """One section of a bond or angle table file: a header line ``N n [FP
    fplo fphi] [EQ eq]``, then ``index x energy force`` rows
    (BondTable::read_table/param_extract, bond_table.cpp:306-500)."""
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
    fpflag, fplo, fphi = False, 0.0, 0.0
    eq = None
    if "FP" in params:
        k = params.index("FP")
        fpflag, fplo, fphi = True, float(params[k + 1]), float(params[k + 2])
    if "EQ" in params:
        eq = float(params[params.index("EQ") + 1])
    i += 2
    rows = []
    while len(rows) < n:
        t = lines[i].split()
        if t:
            rows.append([float(t[1]), float(t[2]), float(t[3])])
        i += 1
    arr = np.array(rows)
    return dict(x=arr[:, 0], e=arr[:, 1], f=arr[:, 2],
                fpflag=fpflag, fplo=fplo, fphi=fphi, eq=eq)


class _Tabulated:
    """The resample and the lookup (bond_table.cpp spline_table,
    compute_table and uf_lookup; angle_table.cpp mirrors them)."""

    def _setup_table(self, ntypes):
        self.tabstyle = "linear"
        self.tablength = 1000
        self._files = {}

    def settings(self, style, n):
        if style not in ("linear", "spline"):
            raise ValueError(f"{self.kind} table style {style!r}")
        self.tabstyle = style
        self.tablength = int(n)

    def _resample(self, tb, lo, hi):
        n = self.tablength
        x, e, f = tb["x"], tb["e"], tb["f"]
        e2f = _spline(x, e, -f[0], -f[-1])
        if tb["fpflag"]:
            fplo, fphi = tb["fplo"], tb["fphi"]
        else:
            fplo = (f[1] - f[0]) / (x[1] - x[0])
            fphi = (f[-1] - f[-2]) / (x[-1] - x[-2])
        f2f = _spline(x, f, fplo, fphi)
        delta = (hi - lo) / (n - 1)
        xs = lo + np.arange(n) * delta
        es = _splint(x, e, e2f, xs)
        fs = _splint(x, f, f2f, xs)
        de = np.empty(n)
        df = np.empty(n)
        de[:-1] = es[1:] - es[:-1]
        df[:-1] = fs[1:] - fs[:-1]
        de[-1] = 2.0 * de[-2] - de[-3]
        df[-1] = 2.0 * df[-2] - df[-3]
        e2 = _spline(xs, es, -fs[0], -fs[-2])
        f2 = _spline(xs, fs, fplo, fphi)
        return dict(lo=lo, hi=hi, delta=delta, x=xs, e=es, f=fs,
                    de=de, df=df, e2=e2, f2=f2)

    def init(self):
        """Stack the per-type resampled tables, flat by type * n + bin."""
        super().init()
        n = self.tablength
        keys = ("e", "f", "de", "df", "e2", "f2", "x")
        tabs = {k: np.zeros((self.ntypes + 1, n)) for k in keys}
        self._lo = np.zeros(self.ntypes + 1)
        self._invdelta = np.ones(self.ntypes + 1)
        self._deltasq6 = np.zeros(self.ntypes + 1)
        for t, tab in self._files.items():
            for k in keys:
                tabs[k][t] = tab[k]
            self._lo[t] = tab["lo"]
            self._invdelta[t] = 1.0 / tab["delta"]
            self._deltasq6[t] = tab["delta"] * tab["delta"] / 6.0
        self._flat = {k: v.reshape(-1) for k, v in tabs.items()}

    def _lookup(self, xval, ttype):
        """(u, f) per tuple: linear or spline interpolation
        (bond_table.cpp:588-616)."""
        n = self.tablength
        lo = self.per(self._lo, xval, ttype)
        invd = self.per(self._invdelta, xval, ttype)
        it = torch.clamp((xval - lo) * invd, 0, n - 1).to(torch.int64)
        base = ttype.to(torch.int64) * n

        def g(k, i):
            return self.table(self._flat[k], xval)[base + i]
        xi = g("x", it)
        if self.tabstyle == "linear":
            frac = (xval - xi) * invd
            return (g("e", it) + frac * g("de", it),
                    g("f", it) + frac * g("df", it))
        b = (xval - xi) * invd
        a = 1.0 - b
        it1 = torch.clamp(it + 1, max=n - 1)
        d6 = self.per(self._deltasq6, xval, ttype)
        u = (a * g("e", it) + b * g("e", it1)
             + ((a ** 3 - a) * g("e2", it)
                + (b ** 3 - b) * g("e2", it1)) * d6)
        f = (a * g("f", it) + b * g("f", it1)
             + ((a ** 3 - a) * g("f2", it)
                + (b ** 3 - b) * g("f2", it1)) * d6)
        return u, f


@register_bonded("bond", "table")
class BondTable(_Tabulated, BondStyle):
    """bond_style table linear|spline N (src/MOLECULE/bond_table.cpp):
    fbond = f(r)/r with f = -dE/dr from the table."""

    name = "table"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self._setup_table(ntypes)
        self.r0 = np.zeros(ntypes + 1)

    def coeff(self, btype, filename, keyword):
        tb = read_bonded_table(filename, keyword)
        self._files[btype] = self._resample(tb, tb["x"][0], tb["x"][-1])
        self.r0[btype] = tb["eq"] if tb["eq"] is not None else 0.0

    def bond_fn(self, r2, btype):
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        u, mdu = self._lookup(r, btype)
        return mdu / r, u


@register_bonded("angle", "table")
class AngleTable(_Tabulated, AngleStyle):
    """angle_style table linear|spline N (src/MOLECULE/angle_table.cpp):
    file angles in degrees over [0, 180], forces converted to
    energy/radian on read; lookup over N uniform bins in [0, pi]."""

    name = "table"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self._setup_table(ntypes)
        self.theta0 = np.full(ntypes + 1, np.pi)

    def coeff(self, atype, filename, keyword):
        tb = read_bonded_table(filename, keyword)
        if abs(tb["x"][0]) > 1e-6 or abs(tb["x"][-1] - 180.0) > 1e-6:
            raise ValueError("Angle table must range from 0 to 180 degrees")
        tb["x"] = tb["x"] * DEG2RAD
        tb["f"] = tb["f"] / DEG2RAD
        self._files[atype] = self._resample(tb, 0.0, np.pi)
        if tb["eq"] is not None:
            self.theta0[atype] = tb["eq"] * DEG2RAD

    def tuple_terms(self, xs, ttype, box, view, ctx, eflag, vflag):
        geo = angle_geometry(xs, box)
        c = geo[-1]
        sv = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
        sv = 1.0 / torch.clamp(sv, min=0.001)
        u, mdu = self._lookup(torch.arccos(c), ttype)
        return self.angle_terms(geo, mdu * sv, u, eflag, vflag)
