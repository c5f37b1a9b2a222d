"""MEAM, the modified embedded atom method (src/MEAM/), the port's copy of
tpumd/models/pair_meam.py.

The reference derives every force term by hand (meam_force.cpp).  Here,
as in tpumd, the total energy is one function of the neighbour
displacements (screening ellipses, the partial densities, G(Gamma), the
embedding and the tabulated pair potential) and the forces and virial
come from its gradient (``EnergyPairStyle``, models/pair_manybody.py).
The set-up below is tpumd's numpy code as it stands.

Setup matches the reference step for step:
- library/parameter file parsing (meam_setup_global.cpp:34-120,
  meam_setup_param.cpp keyword table, pair_meam.cpp:40-44)
- alloy parameter completion + ebound (meam_setup_done.cpp:100-168)
- reference-structure densities (compute_reference_density :586-620)
- the phi(r) table: Rose EOS + reference-config embedding, nn2 series,
  ZBL blend, tabulated at nr=1000 and interpolated with the SAME cubic
  coefficients (:175-313, :946-986) so pair energies agree digit for
  digit with the reference's spline evaluation.

Energy assembly follows meam_dens_init/final:
  E = sum_i F_i(rhobar_i) + sum_{i<j} phi_(ti,tj)(r_ij) S_ij
  S_ij = fcut((rc-r)/delr) * prod_k fcut((C_ikj-Cmin)/(Cmax-Cmin))
"""

from __future__ import annotations

import re as _re

import numpy as np
import torch

from tpumd_torch.models.pair_manybody import EnergyPairStyle, pair_masks
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows

_LAT_Z = {"fcc": 12, "bcc": 8, "hcp": 12, "dim": 1, "dia": 4, "dia3": 4,
          "b1": 6, "c11": 10, "l12": 12, "b2": 8, "sc": 6}
_SHP = {"fcc": (0, 0, 0), "bcc": (0, 0, 0), "b1": (0, 0, 0),
        "b2": (0, 0, 0), "sc": (0, 0, 0), "hcp": (0, 0, 1.0 / 3.0),
        "dia": (0, 0, 32.0 / 9.0), "dia3": (0, 0, 32.0 / 9.0),
        "dim": (1.0, 2.0 / 3.0, 0.40)}


def _fcut(x):
    x = np.asarray(x, np.float64)
    a = 1.0 - np.clip(x, 0.0, 1.0)
    a = a * a
    a = a * a
    return (1.0 - a) ** 2


def _G_gam(gamma, ibar, gsmooth=99.0):
    if ibar in (0, 4):
        sw = -gsmooth / (gsmooth + 1.0)
        if gamma < sw:
            return np.sqrt(1.0 / (gsmooth + 1.0) * (sw / gamma) ** gsmooth)
        return np.sqrt(1.0 + gamma)
    if ibar == 1:
        return np.exp(gamma / 2.0)
    if ibar == 3:
        return 2.0 / (1.0 + np.exp(-gamma))
    if ibar == -5:
        return (np.sqrt(1.0 + gamma) if 1.0 + gamma >= 0
                else -np.sqrt(-1.0 - gamma))
    raise ValueError(f"MEAM ibar {ibar} not supported")


def _embedding(A, Ec, rhobar, emb_lin_neg=0):
    if rhobar > 0:
        return A * Ec * rhobar * np.log(rhobar)
    return 0.0 if emb_lin_neg == 0 else -A * Ec * rhobar


def _erose(r, re_, alpha, Ec, repuls, attrac, form):
    if r <= 0:
        return 0.0
    astar = alpha * (r / re_ - 1.0)
    a3 = attrac if astar >= 0 else repuls
    if form == 1:
        return -Ec * (1 + astar + (-attrac + repuls / r) * astar ** 3) \
            * np.exp(-astar)
    if form == 2:
        return -Ec * (1 + astar + a3 * astar ** 3) * np.exp(-astar)
    return -Ec * (1 + astar + a3 * astar ** 3 / (r / re_)) * np.exp(-astar)


def _zbl(r, z1, z2):
    c = (0.028171, 0.28022, 0.50986, 0.18175)
    d = (0.20162, 0.40290, 0.94229, 3.1998)
    a = 0.4685 / (z1 ** 0.23 + z2 ** 0.23)
    x = r / a
    res = sum(ci * np.exp(-di * x) for ci, di in zip(c, d))
    return res * z1 * z2 / r * 14.3997 if r > 0 else 0.0


def _get_Zij2(lat, cmin, cmax, stheta=1.0):
    """(Zij2, arat, S) — second-neighbor count, distance ratio, screening
    (MEAM::get_Zij2, meam_funcs.cpp:246-375)."""
    table = {"fcc": (6, np.sqrt(2.0), 4), "bcc": (6, 2.0 / np.sqrt(3.0), 4),
             "hcp": (6, np.sqrt(2.0), 4), "b1": (12, np.sqrt(2.0), 2),
             "sc": (12, np.sqrt(2.0), 2), "dia": (12, np.sqrt(8.0 / 3.0), 1),
             "dia3": (12, np.sqrt(11.0 / 3.0), 4),
             "l12": (6, np.sqrt(2.0), 4), "b2": (6, 2.0 / np.sqrt(3.0), 4)}
    if lat in ("dim", "lin", "ch4"):
        return 0, 1.0, 0.0
    Zij2, a, numscr = table[lat]
    C = 1.0 if lat == "dia3" else 4.0 / (a * a) - 1.0
    x = (C - cmin) / (cmax - cmin)
    return Zij2, a, float(_fcut(x)) ** numscr


@register_pair("meam")
class PairMEAM(EnergyPairStyle):
    name = "meam"
    # the screening's (rows, K, K) legs hold 3-vectors
    kk_weight = 3

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.mass = np.zeros(ntypes + 1)

    def settings(self):
        pass

    # ---------------------------------------------------------- file input
    def coeff(self, ilo, ihi, jlo, jhi, libfile, *args):
        """pair_coeff * * lib.meam Elem1..ElemN paramfile Type1Elem..."""
        args = [str(a) for a in args]
        nlib = len(args) - 1 - self.ntypes
        lib_elems = args[:nlib]
        paramfile = args[nlib]
        type_elems = args[nlib + 1:]
        self._read_library(str(libfile), lib_elems)
        if paramfile not in ("NULL", "none"):
            self._read_params(paramfile, lib_elems)
        # fmap: type -> element index
        self.fmap = np.zeros(self.ntypes + 1, np.int64)
        for t, nm in enumerate(type_elems, start=1):
            self.fmap[t] = lib_elems.index(nm)
            self.mass[t] = self.atwt[self.fmap[t]]

    def _read_library(self, path, elems):
        toks = []
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if line:
                    toks.extend(line.split())
        # entries are 19 tokens each: 'elt' 'lat' z ielement atwt /
        # alpha b0 b1 b2 b3 alat esub asub / t0 t1 t2 t3 rozero ibar
        entries = {}
        i = 0
        while i + 19 <= len(toks):
            name = toks[i].strip("'\"")
            lat = toks[i + 1].strip("'\"").lower()
            vals = [float(v) for v in toks[i + 2:i + 19]]
            if name not in entries:
                entries[name] = (lat, vals)
            i += 19
        n = len(elems)
        self.nelt = n
        self.lat = [["" for _ in range(n)] for _ in range(n)]
        self.ielt = np.zeros(n, np.int64)
        self.atwt = np.zeros(n)
        self.alpha = np.zeros((n, n))
        self.beta = np.zeros((n, 4))
        self.Ec = np.zeros((n, n))
        self.A = np.zeros(n)
        self.t = np.zeros((n, 4))
        self.rho0 = np.zeros(n)
        self.ibar = np.zeros(n, np.int64)
        self.re = np.zeros((n, n))
        for a, nm in enumerate(elems):
            if nm not in entries:
                raise ValueError(f"element {nm!r} not in MEAM library")
            lat, v = entries[nm]
            self.lat[a][a] = lat
            self.ielt[a] = int(v[1])
            self.atwt[a] = v[2]
            self.alpha[a, a] = v[3]
            self.beta[a] = v[4:8]
            alat = v[8]
            self.Ec[a, a] = v[9]
            self.A[a] = v[10]
            self.t[a] = v[11:15]
            self.rho0[a] = v[15]
            self.ibar[a] = int(v[16])
            if lat == "fcc":
                self.re[a, a] = alat / np.sqrt(2.0)
            elif lat == "bcc":
                self.re[a, a] = alat * np.sqrt(3.0) / 2.0
            elif lat in ("hcp", "dim", "sc"):
                self.re[a, a] = alat
            elif lat in ("dia", "dia3"):
                self.re[a, a] = alat * np.sqrt(3.0) / 4.0
            else:
                raise ValueError(f"MEAM lattice {lat!r} not supported")
        # defaults (meam_setup_global.cpp:105-121)
        self.rc = 4.0
        self.delr = 0.1
        self.attrac = np.zeros((n, n))
        self.repuls = np.zeros((n, n))
        self.Cmax = np.full((n, n, n), 2.8)
        self.Cmin = np.full((n, n, n), 2.0)
        self.delta = np.zeros((n, n))
        self.nn2 = np.zeros((n, n), np.int64)
        self.zbl = np.ones((n, n), np.int64)
        self.gsmooth = 99.0
        self.augt1 = 1
        self.ialloy = 0
        self.mix_ref_t = 0
        self.emb_lin_neg = 0
        self.bkgd_dyn = 0
        self.erose_form = 0

    def _read_params(self, path, elems):
        """keyword(i[,j[,k]]) = value lines (meam_setup_param.cpp)."""
        pat = _re.compile(r"^\s*(\w+)\s*(?:\(([^)]*)\))?\s*=\s*(\S+)")
        with open(path) as fh:
            for raw in fh:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                m = pat.match(line)
                if not m:
                    continue
                key, idxs, val = m.groups()
                ix = [int(v) - 1 for v in idxs.split(",")] if idxs else []
                sval = val.strip("'\"")
                if key == "Ec":
                    self.Ec[ix[0], ix[1]] = float(sval)
                elif key == "alpha":
                    self.alpha[ix[0], ix[1]] = float(sval)
                elif key == "rho0":
                    self.rho0[ix[0]] = float(sval)
                elif key == "delta":
                    self.delta[ix[0], ix[1]] = float(sval)
                elif key == "lattce":
                    self.lat[ix[0]][ix[1]] = sval.lower()
                elif key == "attrac":
                    self.attrac[ix[0], ix[1]] = float(sval)
                elif key == "repuls":
                    self.repuls[ix[0], ix[1]] = float(sval)
                elif key == "nn2":
                    i1, i2 = min(ix[0], ix[1]), max(ix[0], ix[1])
                    self.nn2[i1, i2] = int(float(sval))
                elif key == "Cmin":
                    self.Cmin[ix[0], ix[1], ix[2]] = float(sval)
                elif key == "Cmax":
                    self.Cmax[ix[0], ix[1], ix[2]] = float(sval)
                elif key == "rc":
                    self.rc = float(sval)
                elif key == "delr":
                    self.delr = float(sval)
                elif key == "augt1":
                    self.augt1 = int(float(sval))
                elif key == "gsmooth_factor":
                    self.gsmooth = float(sval)
                elif key == "re":
                    self.re[ix[0], ix[1]] = float(sval)
                elif key == "ialloy":
                    self.ialloy = int(float(sval))
                elif key == "mixture_ref_t":
                    self.mix_ref_t = int(float(sval))
                elif key == "erose_form":
                    self.erose_form = int(float(sval))
                elif key == "zbl":
                    i1, i2 = min(ix[0], ix[1]), max(ix[0], ix[1])
                    self.zbl[i1, i2] = int(float(sval))
                elif key == "emb_lin_neg":
                    self.emb_lin_neg = int(float(sval))
                elif key == "bkgd_dyn":
                    self.bkgd_dyn = int(float(sval))
                else:
                    raise ValueError(f"MEAM parameter {key!r} unsupported")

    # ------------------------------------------------------------ setup_done
    def init(self):
        n = self.nelt
        if self.mix_ref_t:
            raise ValueError("MEAM mixture_ref_t not supported")
        # augment t1 (meam_setup_done.cpp:36-37)
        if not getattr(self, "_t1_augmented", False):
            self.t[:, 1] = self.t[:, 1] + self.augt1 * 0.6 * self.t[:, 3]
            self._t1_augmented = True
        # alloyparams (:100-168)
        for i in range(n):
            for j in range(n):
                if i > j:
                    self.re[i, j] = self.re[j, i]
                    self.Ec[i, j] = self.Ec[j, i]
                    self.alpha[i, j] = self.alpha[j, i]
                    self.lat[i][j] = self.lat[j][i]
                    self.nn2[i, j] = self.nn2[j, i]
                elif j > i:
                    if not self.lat[i][j]:
                        raise ValueError(
                            f"MEAM: no reference lattice for pair {i},{j}")
                    if self.Ec[i, j] == 0.0:
                        if self.lat[i][j] == "l12":
                            self.Ec[i, j] = (3 * self.Ec[i, i]
                                             + self.Ec[j, j]) / 4.0 \
                                - self.delta[i, j]
                        else:
                            self.Ec[i, j] = (self.Ec[i, i]
                                             + self.Ec[j, j]) / 2.0 \
                                - self.delta[i, j]
                    if self.alpha[i, j] == 0.0:
                        self.alpha[i, j] = (self.alpha[i, i]
                                            + self.alpha[j, j]) / 2.0
                    if self.re[i, j] == 0.0:
                        self.re[i, j] = (self.re[i, i]
                                         + self.re[j, j]) / 2.0
        for i in range(1, n):
            for j in range(i):
                for k in range(n):
                    self.Cmin[i, j, k] = self.Cmin[j, i, k]
                    self.Cmax[i, j, k] = self.Cmax[j, i, k]
        eb = (self.Cmax ** 2) / (4.0 * (self.Cmax - 1.0))
        self.ebound = eb.max(axis=2)
        self._reference_density()
        self._build_phi_table()
        self.drop_tables()

    def _shp(self, lat):
        if lat not in _SHP:
            raise ValueError(f"MEAM lattice {lat!r} not supported")
        return _SHP[lat]

    def _reference_density(self):
        """compute_reference_density (meam_setup_done.cpp:586-620)."""
        n = self.nelt
        self.rho_ref = np.zeros(n)
        for a in range(n):
            lat = self.lat[a][a]
            Z = _LAT_Z[lat]
            if self.ibar[a] <= 0:
                Gbar = 1.0
            else:
                shp = self._shp(lat)
                gam = (self.t[a, 1] * shp[0] + self.t[a, 2] * shp[1]
                       + self.t[a, 3] * shp[2]) / (Z * Z)
                Gbar = _G_gam(gam, self.ibar[a], self.gsmooth)
            rho0 = self.rho0[a] * Z
            if self.nn2[a, a] == 1:
                Z2, arat, scrn = _get_Zij2(lat, self.Cmin[a, a, a],
                                           self.Cmax[a, a, a])
                rho0 += Z2 * self.rho0[a] * np.exp(
                    -self.beta[a, 0] * (arat - 1.0)) * scrn
            self.rho_ref[a] = rho0 * Gbar

    def _densref(self, r, a, b):
        """get_densref (meam_setup_done.cpp:689-943)."""
        a1 = r / self.re[a, a] - 1.0
        a2 = r / self.re[b, b] - 1.0
        rhoa1 = self.rho0[a] * np.exp(-self.beta[a] * a1)   # (4,)
        rhoa2 = self.rho0[b] * np.exp(-self.beta[b] * a2)
        lat = self.lat[a][b]
        out1 = np.zeros(4)
        out2 = np.zeros(4)
        if lat == "fcc":
            out1[0] = 12.0 * rhoa2[0]
            out2[0] = 12.0 * rhoa1[0]
        elif lat == "bcc":
            out1[0] = 8.0 * rhoa2[0]
            out2[0] = 8.0 * rhoa1[0]
        elif lat in ("b1", "sc"):
            out1[0] = 6.0 * rhoa2[0]
            out2[0] = 6.0 * rhoa1[0]
        elif lat in ("dia", "dia3"):
            out1[0] = 4.0 * rhoa2[0]
            out2[0] = 4.0 * rhoa1[0]
            out1[3] = 32.0 / 9.0 * rhoa2[3] ** 2
            out2[3] = 32.0 / 9.0 * rhoa1[3] ** 2
        elif lat == "hcp":
            out1[0] = 12.0 * rhoa2[0]
            out2[0] = 12.0 * rhoa1[0]
            out1[3] = (rhoa2[3] ** 2) / 3.0
            out2[3] = (rhoa1[3] ** 2) / 3.0
        elif lat == "dim":
            s = _SHP["dim"]
            out1[0] = rhoa2[0]
            out2[0] = rhoa1[0]
            for m in range(1, 4):
                out1[m] = s[m - 1] * rhoa2[m] ** 2
                out2[m] = s[m - 1] * rhoa1[m] ** 2
        elif lat == "b2":
            out1[0] = 8.0 * rhoa2[0]
            out2[0] = 8.0 * rhoa1[0]
        else:
            raise ValueError(f"MEAM reference lattice {lat!r} unsupported")
        if self.nn2[a, b] == 1:
            Z2, arat, scrn = _get_Zij2(lat, self.Cmin[a, a, b],
                                       self.Cmax[a, a, b])
            a1n = arat * r / self.re[a, a] - 1.0
            a2n = arat * r / self.re[b, b] - 1.0
            out1[0] += Z2 * scrn * self.rho0[a] * np.exp(
                -self.beta[a, 0] * a1n)
            Z2, arat, scrn = _get_Zij2(lat, self.Cmin[b, b, a],
                                       self.Cmax[b, b, a])
            out2[0] += Z2 * scrn * self.rho0[b] * np.exp(
                -self.beta[b, 0] * a2n)
        return out1, out2

    def _phi_meam(self, r, a, b):
        """phi_meam (meam_setup_done.cpp:318-557)."""
        lat = self.lat[a][b]
        Z1 = _LAT_Z[self.lat[a][a]]
        Z2 = _LAT_Z[self.lat[b][b]]
        Z12 = _LAT_Z[lat]
        d1, d2 = self._densref(r, a, b)
        rho01, rho11, rho21, rho31 = d1
        rho02, rho12, rho22, rho32 = d2
        if rho01 <= 1e-14 and rho02 <= 1e-14:
            return 0.0
        # tavref: all listed lattices have opposite-type neighbors
        t1av = self.t[b, 1:4] if self.ialloy != 2 else self.t[a, 1:4]
        t2av = self.t[a, 1:4] if self.ialloy != 2 else self.t[b, 1:4]
        Gam1 = (t1av[0] * rho11 + t1av[1] * rho21 + t1av[2] * rho31)
        Gam1 = 0.0 if rho01 < 1e-14 else Gam1 / (rho01 * rho01)
        Gam2 = (t2av[0] * rho12 + t2av[1] * rho22 + t2av[2] * rho32)
        Gam2 = 0.0 if rho02 < 1e-14 else Gam2 / (rho02 * rho02)
        G1 = _G_gam(Gam1, self.ibar[a], self.gsmooth)
        G2 = _G_gam(Gam2, self.ibar[b], self.gsmooth)
        if self.bkgd_dyn == 1:
            bk1 = self.rho0[a] * Z1
            bk2 = self.rho0[b] * Z2
        else:
            bk1 = self.rho_ref[a]
            bk2 = self.rho_ref[b]
        rhobar1 = rho01 / bk1 * G1
        rhobar2 = rho02 / bk2 * G2
        F1 = _embedding(self.A[a], self.Ec[a, a], rhobar1,
                        self.emb_lin_neg)
        F2 = _embedding(self.A[b], self.Ec[b, b], rhobar2,
                        self.emb_lin_neg)
        Eu = _erose(r, self.re[a, b], self.alpha[a, b], self.Ec[a, b],
                    self.repuls[a, b], self.attrac[a, b], self.erose_form)
        phi_m = (2 * Eu - F1 - F2) / Z12
        if r == 0.0:
            phi_m = 0.0
        return phi_m

    def _phi_series(self, scrn, Z1, Z2, a, b, r, arat):
        total = 0.0
        if scrn > 0.0:
            b2nn = -Z2 * scrn / Z1
            for nn in range(1, 11):
                val = b2nn ** nn * self._phi_meam(r * arat ** nn, a, b)
                if val == 0.0:
                    break
                total += val
        return total

    def _build_phi_table(self):
        """compute_pair_meam + interpolate_meam (:175-313, :946-986)."""
        n = self.nelt
        nr = 1000
        dr = 1.1 * self.rc / nr
        npair = n * (n + 1) // 2
        phir = np.zeros((npair, nr))
        self.eltind = np.zeros((n, n), np.int64)
        nv2 = 0
        for a in range(n):
            for b in range(a, n):
                self.eltind[a, b] = self.eltind[b, a] = nv2
                lat = self.lat[a][b]
                for j in range(nr):
                    r = j * dr
                    phi = self._phi_meam(r, a, b)
                    if self.nn2[a, b] == 1:
                        Z1 = _LAT_Z[lat]
                        Z2, arat, scrn = _get_Zij2(
                            lat, self.Cmin[a, a, b], self.Cmax[a, a, b])
                        if lat in ("b1", "b2", "dia", "l12"):
                            rarat = r * arat
                            phiaa = self._phi_meam(rarat, a, a)
                            Z1aa, ar2, s2 = (
                                _LAT_Z[self.lat[a][a]],) + _get_Zij2(
                                self.lat[a][a], self.Cmin[a, a, a],
                                self.Cmax[a, a, a])[1:]
                            Z2aa = _get_Zij2(
                                self.lat[a][a], self.Cmin[a, a, a],
                                self.Cmax[a, a, a])[0]
                            phiaa += self._phi_series(
                                s2, Z1aa, Z2aa, a, a, rarat, ar2)
                            phibb = self._phi_meam(rarat, b, b)
                            Z1bb = _LAT_Z[self.lat[b][b]]
                            Z2bb, ar3, s3 = _get_Zij2(
                                self.lat[b][b], self.Cmin[b, b, b],
                                self.Cmax[b, b, b])
                            phibb += self._phi_series(
                                s3, Z1bb, Z2bb, b, b, rarat, ar3)
                            if lat in ("b1", "b2", "dia"):
                                Z1x = _LAT_Z[lat]
                                Z2x, _, sx = _get_Zij2(
                                    lat, self.Cmin[a, a, b],
                                    self.Cmax[a, a, b])
                                phi -= Z2x * sx / (2 * Z1x) * phiaa
                                Z2y, _, sy = _get_Zij2(
                                    lat, self.Cmin[b, b, a],
                                    self.Cmax[b, b, a])
                                phi -= Z2y * sy / (2 * Z1x) * phibb
                        else:
                            phi += self._phi_series(
                                scrn, Z1, Z2, a, b, r, arat)
                    if self.zbl[min(a, b), max(a, b)] == 1:
                        astar = self.alpha[a, b] * (r / self.re[a, b] - 1.0)
                        if astar <= -3.0:
                            phi = _zbl(r, self.ielt[a], self.ielt[b])
                        elif astar < -1.0:
                            frac = _fcut(1 - (astar + 1.0) / (-3.0 + 1.0))
                            phi = frac * phi + (1 - frac) * _zbl(
                                r, self.ielt[a], self.ielt[b])
                    phir[nv2, j] = phi
                nv2 += 1
        # interpolate_meam: quartic-difference first derivatives + cubic
        p1 = np.zeros_like(phir)
        p1[:, 0] = phir[:, 1] - phir[:, 0]
        p1[:, 1] = 0.5 * (phir[:, 2] - phir[:, 0])
        p1[:, nr - 2] = 0.5 * (phir[:, nr - 1] - phir[:, nr - 3])
        p1[:, nr - 1] = 0.0
        p1[:, 2:nr - 2] = ((phir[:, 0:nr - 4] - phir[:, 4:nr])
                           + 8.0 * (phir[:, 3:nr - 1]
                                    - phir[:, 1:nr - 3])) / 12.0
        p2 = np.zeros_like(phir)
        p3 = np.zeros_like(phir)
        p2[:, :nr - 1] = (3.0 * (phir[:, 1:] - phir[:, :nr - 1])
                          - 2.0 * p1[:, :nr - 1] - p1[:, 1:])
        p3[:, :nr - 1] = (p1[:, :nr - 1] + p1[:, 1:]
                          - 2.0 * (phir[:, 1:] - phir[:, :nr - 1]))
        self._phi_tab = np.stack([phir, p1, p2, p3], axis=-1)  # (np, nr, 4)
        self._nr = nr
        self._rdrar = 1.0 / dr

    @property
    def max_cutoff(self):
        return float(self.rc)

    # -------------------------------------------------------------- energy
    def _dev(self, name, like, dtype=None):
        """The numpy array ``name`` (an attribute, or a callable's value)
        on like's device, in dtype (like's by default), once per set-up."""
        key = (name, like.device, dtype or like.dtype)
        cache = self.__dict__.setdefault("_dev_tables", {})
        if key not in cache:
            a = getattr(self, name)
            cache[key] = torch.as_tensor(np.array(a() if callable(a) else a),
                                         dtype=key[2], device=like.device)
        return cache[key]

    def _diag_re(self):
        return np.diag(self.re)

    def _diag_Ec(self):
        return np.diag(self.Ec)

    def _bkgd_z(self):
        return np.asarray([_LAT_Z[self.lat[a][a]] for a in range(self.nelt)],
                          np.float64)

    def _phi_packed(self):
        return self._phi_tab.reshape(-1, 4)

    def energy(self, d, it, jt, idx, rows):
        i64 = torch.int64
        fmap = self._dev("fmap", d, i64)
        elti = fmap[it]                                       # (n, 1)
        eltj = fmap[jt]                                       # (n, K)
        rc = self.rc
        r2, in2 = pair_masks(d, idx, rows, rc)
        r = torch.sqrt(torch.where(in2, r2, 1.0))
        rs = torch.where(in2, r, rc + 1.0)

        # the screening S_ij (getscreen, meam_dens_init.cpp:134-291)
        def fcut(xv):
            a = 1.0 - torch.clamp(xv, 0.0, 1.0)
            a = a * a
            a = a * a
            return (1.0 - a) ** 2

        eltk = eltj[:, None, :]
        ei3 = elti[:, :, None]
        ej3 = eltj[:, :, None]
        dik = d[:, None, :, :]
        djk = d[:, None, :, :] - d[:, :, None, :]             # (n, j, k, 3)
        rik2 = torch.sum(dik * dik, -1)
        rjk2 = torch.sum(djk * djk, -1)
        rij2 = torch.where(in2, r2, 1.0)[:, :, None]
        xik = rik2 / rij2
        xjk = rjk2 / rij2
        aell = 1.0 - (xik - xjk) * (xik - xjk)
        C = torch.where(aell > 0, (2.0 * (xik + xjk) + aell - 2.0)
                        / torch.where(aell > 0, aell, 1.0), 1e30)
        cmin3 = self._dev("Cmin", d)[ei3, ej3, eltk]
        cmax3 = self._dev("Cmax", d)[ei3, ej3, eltk]
        xs = (C - cmin3) / (cmax3 - cmin3)
        sikj = torch.where(aell > 0, fcut(xs), 1.0)
        # k == j, padding, or k beyond the cutoff: no screening
        samej = idx[:, :, None] == idx[:, None, :]
        kvalid = in2[:, None, :] & ~samej
        sikj = torch.where(kvalid, sikj, 1.0)
        sij = torch.prod(sikj, dim=2)
        fcij = fcut((rc - rs) / self.delr)
        sfc = torch.where(in2, sij * fcij, 0.0)               # (n, K)

        # the partial densities (calc_rho1, meam_dens_init.cpp:292-420)
        beta = self._dev("beta", d)                           # (nelt, 4)
        rho0e = self._dev("rho0", d)
        ree = self._dev("_diag_re", d)
        aj = rs / ree[eltj] - 1.0
        rhoa = rho0e[eltj][..., None] * torch.exp(-beta[eltj]
                                                  * aj[..., None])
        tj = self._dev("t", d)[eltj]                          # (n, K, 4)
        if self.ialloy == 1:
            rhoa = torch.cat([rhoa[..., :1], rhoa[..., 1:] * tj[..., 1:]],
                             dim=-1)
        rhoa = rhoa * sfc[..., None]
        rho0_i = torch.sum(rhoa[..., 0], 1)
        rhat = d / rs[..., None]
        arho1 = torch.sum(rhoa[..., 1:2] * rhat, 1)           # (n, 3)
        arho2b = torch.sum(rhoa[..., 2], 1)
        pair2 = rhat[:, :, :, None] * rhat[:, :, None, :]     # (n, K, 3, 3)
        arho2 = torch.sum(rhoa[..., 2, None, None] * pair2, 1)
        arho3b = torch.sum(rhoa[..., 3:4] * rhat, 1)
        pair3 = pair2[..., None] * rhat[:, :, None, None, :]
        arho3 = torch.sum(rhoa[..., 3, None, None, None] * pair3, 1)
        # the t averages
        ei = fmap[it[:, 0]]
        if self.ialloy == 1:
            num = torch.sum(tj[..., 1:] * rhoa[..., 0:1], 1)
            den = torch.sum(tj[..., 1:] ** 2 * rhoa[..., 0:1], 1)
            t_ave = torch.where(den != 0, num / torch.where(den != 0, den,
                                                            1.0), 0.0)
        elif self.ialloy == 2:
            t_ave = self._dev("t", d)[ei][:, 1:]
        else:
            num = torch.sum(tj[..., 1:] * rhoa[..., 0:1], 1)
            pos = rho0_i[:, None] > 0
            t_ave = torch.where(pos, num / torch.where(pos, rho0_i[:, None],
                                                       1.0), 0.0)

        rho1 = torch.sum(arho1 * arho1, -1)
        rho2 = torch.sum(arho2 * arho2, (-1, -2)) - arho2b ** 2 / 3.0
        rho3 = (torch.sum(arho3 * arho3, (-1, -2, -3))
                - 0.6 * torch.sum(arho3b * arho3b, -1))
        gamma = (t_ave[:, 0] * rho1 + t_ave[:, 1] * rho2
                 + t_ave[:, 2] * rho3)
        gamma = torch.where(rho0_i > 0, gamma / torch.where(
            rho0_i > 0, rho0_i ** 2, 1.0), 0.0)

        # G(gamma) by each element's ibar (G_gam, meam_funcs.cpp:35-64)
        ibar = self._dev("ibar", d, i64)[ei]
        gs = self.gsmooth
        sw = -gs / (gs + 1.0)
        g_smooth = torch.sqrt(1.0 / (gs + 1.0) * torch.abs(
            sw / torch.where(gamma < sw, gamma, -1.0)) ** gs)
        g_sqrt = torch.sqrt(torch.clamp(1.0 + gamma, min=1e-30))
        g04 = torch.where(gamma < sw, g_smooth, g_sqrt)
        g1 = torch.exp(gamma / 2.0)
        g3 = 2.0 / (1.0 + torch.exp(-gamma))
        gm5 = torch.where(1.0 + gamma >= 0, g_sqrt,
                          -torch.sqrt(torch.clamp(-1.0 - gamma, min=1e-30)))
        G = torch.where(ibar == 1, g1,
                        torch.where(ibar == 3, g3,
                                    torch.where(ibar == -5, gm5, g04)))
        if self.bkgd_dyn == 0:
            rho_bkgd = self._dev("rho_ref", d)[ei]
        else:
            rho_bkgd = rho0e[ei] * self._dev("_bkgd_z", d)[ei]
        rhob = rho0_i * G / rho_bkgd

        AEc = self._dev("A", d)[ei] * self._dev("_diag_Ec", d)[ei]
        lrb = torch.log(torch.where(rhob > 0, rhob, 1.0))
        if self.emb_lin_neg == 0:
            F = torch.where(rhob > 0, AEc * rhob * lrb, 0.0)
        else:
            F = torch.where(rhob > 0, AEc * rhob * lrb, -AEc * rhob)

        # the pair energy from the tabulated phi (meam_force.cpp:104-117):
        # the coefficient rows by one P1 gather
        ind = self._dev("eltind", d, i64)[elti, eltj]         # (n, K)
        pp = rs * self._rdrar
        kk = torch.clamp(pp.detach().to(torch.int32), max=self._nr - 2)
        pp = torch.clamp(pp - kk, max=1.0)
        flat = (ind * self._nr + kk).to(torch.int32).contiguous()
        cf = gather_rows(self._dev("_phi_packed", d), flat)   # (n, K, 4)
        phi = ((cf[..., 3] * pp + cf[..., 2]) * pp
               + cf[..., 1]) * pp + cf[..., 0]
        e_pair = 0.5 * torch.sum(torch.where(in2, phi * sfc, 0.0))
        return torch.sum(F) + e_pair
