"""Assorted pairwise styles: born, buck, coul/cut, coul/debye, gauss,
lj/cut/coul/cut, lj/cut/coul/long, lj/expand, morse, soft, yukawa, zero.

PyTorch counterpart of tpumd/models/pair_misc.py, on the matrix neighbor
engine through ``pair_sums``; physics per the reference kernels
(src/pair_morse.cpp, pair_buck.cpp, pair_yukawa.cpp, pair_coul_cut.cpp,
pair_born.cpp, pair_lj_expand.cpp, pair_coul_debye.cpp,
src/KSPACE/pair_lj_cut_coul_long.cpp, ...), with each style's shift
offsets where tpumd has them.  Per-type-pair coefficients are read with
``pair_coeffs``; a style that weighs special pairs itself (the Coulomb
styles) gives ``pair_fn_ex``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpumd_torch.models.base import SimpleTablePair
from tpumd_torch.models.registry import register_pair

# the reference's erfc polynomial (src/KSPACE/pair_lj_cut_coul_long.cpp)
EWALD_F = 1.12837917
EWALD_P = 0.3275911
A1, A2, A3, A4, A5 = (0.254829592, -0.284496736, 1.421413741,
                      -1.453152027, 1.061405429)


def coul_long_terms(pair, r2, w_coul, qi, qj):
    """(ecoul, fcoul) of real-space Ewald Coulomb within pair.cut_coulsq,
    the excluded share (1 - w_coul) of the bare Coulomb taken off
    (src/KSPACE/pair_lj_cut_coul_long.cpp:110-125)."""
    in_c = r2 < pair.cut_coulsq
    r = torch.sqrt(r2)
    grij = pair.g_ewald * r
    expm2 = torch.exp(-grij * grij)
    t = 1.0 / (1.0 + EWALD_P * grij)
    erfc = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2
    prefactor = pair.units.qqr2e * qi * qj / r
    forcecoul = prefactor * (erfc + EWALD_F * grij * expm2) \
        - (1.0 - w_coul) * prefactor
    ec = torch.where(in_c, prefactor * erfc - (1.0 - w_coul) * prefactor,
                     0.0)
    fcoul = torch.where(in_c, forcecoul / r2, 0.0)
    return ec, fcoul


def coul_cut_terms(pair, r2, w_coul, qi, qj):
    """(ecoul, fcoul) of bare Coulomb within pair.cut_coulsq."""
    in_c = r2 < pair.cut_coulsq
    forcecoul = pair.units.qqr2e * qi * qj / torch.sqrt(r2)
    fcoul = torch.where(in_c, w_coul * forcecoul / r2, 0.0)
    ec = torch.where(in_c, w_coul * forcecoul, 0.0)
    return ec, fcoul


def lj_terms(pair, r2, it, jt, w_lj):
    """(fpair, evdwl) of 12-6 LJ from pair's lj1-lj4 and cutsq."""
    lj1, lj2, lj3, lj4, cutsq = pair.pair_coeffs(
        r2, it, jt, "lj1", "lj2", "lj3", "lj4", "cutsq")
    in_lj = r2 < cutsq
    r2inv = 1.0 / r2
    r6inv = r2inv ** 3
    forcelj = r6inv * (lj1 * r6inv - lj2)
    fpair = torch.where(in_lj, w_lj * forcelj * r2inv, 0.0)
    e = torch.where(in_lj, w_lj * r6inv * (lj3 * r6inv - lj4), 0.0)
    return fpair, e


def lj_tables(pair):
    eps, sig = pair.params[0], pair.params[1]
    pair.lj1 = 48.0 * eps * sig ** 12
    pair.lj2 = 24.0 * eps * sig ** 6
    pair.lj3 = 4.0 * eps * sig ** 12
    pair.lj4 = 4.0 * eps * sig ** 6


class CoulCutoff:
    """A style with a Coulomb cutoff of its own: settings(cut_lj
    [cut_coul]), the neighbor cutoff the larger of the two."""

    def settings(self, cut_lj, cut_coul=None):
        self.cut_global = float(cut_lj)
        self.cut_coul = float(cut_coul if cut_coul is not None else cut_lj)

    @property
    def max_cutoff(self):
        return max(float(self.cut[1:, 1:].max()), self.cut_coul)


@register_pair("morse")
class PairMorse(SimpleTablePair):
    """E = D0[e^{-2a(r-r0)} - 2e^{-a(r-r0)}] (src/pair_morse.cpp)."""

    name = "morse"
    ncoeff = 3  # d0, alpha, r0

    def derive(self):
        d0, alpha, r0 = self.params
        self.morse1 = 2.0 * d0 * alpha
        if self.shift:
            ratio = np.exp(-alpha * (self.cut - r0))
            self.offset = np.where(self.cut > 0,
                                   d0 * (ratio ** 2 - 2 * ratio), 0)
        else:
            self.offset = np.zeros_like(d0)

    def pair_fn(self, r2, it, jt):
        d0, alpha, r0, m1, off, cutsq = self.pair_coeffs(
            r2, it, jt, "p0", "p1", "p2", "morse1", "offset", "cutsq")
        inside = r2 < cutsq
        r = torch.sqrt(r2)
        ralpha = torch.exp(-alpha * (r - r0))
        fpair = torch.where(inside, m1 * (ralpha * ralpha - ralpha) / r, 0.0)
        e = torch.where(inside, d0 * (ralpha * ralpha - 2.0 * ralpha) - off,
                        0.0)
        return fpair, e


@register_pair("buck")
class PairBuck(SimpleTablePair):
    """E = A e^{-r/rho} - C/r^6 (src/pair_buck.cpp)."""

    name = "buck"
    ncoeff = 3  # a, rho, c

    def pair_fn(self, r2, it, jt):
        a, rho, c, cutsq = self.pair_coeffs(r2, it, jt, "p0", "p1", "p2",
                                            "cutsq")
        inside = r2 < cutsq
        r = torch.sqrt(r2)
        r2inv = 1.0 / r2
        r6inv = r2inv ** 3
        rho = torch.clamp(rho, min=1e-30)
        rexp = torch.exp(-r / rho)
        forcebuck = a / rho * r * rexp - 6.0 * c * r6inv
        fpair = torch.where(inside, forcebuck * r2inv, 0.0)
        e = torch.where(inside, a * rexp - c * r6inv, 0.0)
        return fpair, e


@register_pair("yukawa")
class PairYukawa(SimpleTablePair):
    """E = A e^{-kappa r}/r (src/pair_yukawa.cpp); kappa in settings."""

    name = "yukawa"
    ncoeff = 1  # a

    def settings(self, kappa, cut_global):
        self.kappa = float(kappa)
        self.cut_global = float(cut_global)

    def pair_fn(self, r2, it, jt):
        a, cutsq = self.pair_coeffs(r2, it, jt, "p0", "cutsq")
        inside = r2 < cutsq
        r = torch.sqrt(r2)
        rinv = 1.0 / r
        screening = torch.exp(-self.kappa * r)
        forceyuk = a * screening * (self.kappa + rinv)
        fpair = torch.where(inside, forceyuk * rinv * rinv, 0.0)
        e = torch.where(inside, a * screening * rinv, 0.0)
        return fpair, e


class _CutOnly(SimpleTablePair):
    """pair_coeff takes at most a cutoff."""

    ncoeff = 0

    def coeff(self, ilo, ihi, jlo, jhi, *vals):
        cut = vals[0] if vals else self.cut_global
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.cut[i, j] = cut
                self._setflag[i, j] = True


@register_pair("coul/cut")
class PairCoulCut(_CutOnly):
    """E = C q_i q_j / r, truncated (src/pair_coul_cut.cpp)."""

    name = "coul/cut"

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        (cutsq,) = self.pair_coeffs(r2, it, jt, "cutsq")
        inside = r2 < cutsq
        rinv = 1.0 / torch.sqrt(r2)
        forcecoul = self.units.qqr2e * qi * qj * rinv
        fcoul = torch.where(inside, w_coul * forcecoul / r2, 0.0)
        ec = torch.where(inside, w_coul * forcecoul, 0.0)
        return torch.zeros_like(r2), torch.zeros_like(r2), ec, fcoul


@register_pair("lj/cut/coul/cut")
class PairLJCutCoulCut(CoulCutoff, SimpleTablePair):
    name = "lj/cut/coul/cut"
    ncoeff = 2  # epsilon sigma

    def derive(self):
        lj_tables(self)
        self.cut_coulsq = self.cut_coul ** 2

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = lj_terms(self, r2, it, jt, w_lj)
        if qi is None:
            return fpair, e, None, None
        ec, fcoul = coul_cut_terms(self, r2, w_coul, qi, qj)
        return fpair, e, ec, fcoul


@register_pair("lj/cut/coul/long")
class PairLJCutCoulLong(PairLJCutCoulCut):
    """LJ + Ewald-erfc Coulomb (src/KSPACE/pair_lj_cut_coul_long.cpp)."""

    name = "lj/cut/coul/long"
    g_ewald = 0.0

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = lj_terms(self, r2, it, jt, w_lj)
        ec, fcoul = coul_long_terms(self, r2, w_coul, qi, qj)
        return fpair, e, ec, fcoul


@register_pair("soft")
class PairSoft(SimpleTablePair):
    """E = A(1 + cos(pi r / rc)) (src/pair_soft.cpp)."""

    name = "soft"
    ncoeff = 1

    def pair_fn(self, r2, it, jt):
        a, cut = self.pair_coeffs(r2, it, jt, "p0", "cut")
        inside = r2 < cut * cut
        r = torch.sqrt(r2)
        arg = math.pi / torch.clamp(cut, min=1e-30)
        fpair = torch.where(inside & (r > 0), a * arg * torch.sin(arg * r)
                            / torch.clamp(r, min=1e-30), 0.0)
        e = torch.where(inside, a * (1.0 + torch.cos(arg * r)), 0.0)
        return fpair, e


@register_pair("gauss")
class PairGauss(SimpleTablePair):
    """E = -A exp(-B r^2) (src/pair_gauss.cpp)."""

    name = "gauss"
    ncoeff = 2

    def pair_fn(self, r2, it, jt):
        a, b, cutsq = self.pair_coeffs(r2, it, jt, "p0", "p1", "cutsq")
        inside = r2 < cutsq
        fpair = torch.where(inside, -2.0 * a * b * torch.exp(-b * r2), 0.0)
        e = torch.where(inside, -a * torch.exp(-b * r2), 0.0)
        return fpair, e


@register_pair("zero")
class PairZero(SimpleTablePair):
    """No interactions, only a neighbor cutoff (src/pair_zero.cpp)."""

    name = "zero"
    ncoeff = 0

    def coeff(self, ilo, ihi, jlo, jhi, *vals):
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.cut[i, j] = self.cut_global
                self._setflag[i, j] = True

    def pair_fn(self, r2, it, jt):
        z = torch.zeros_like(r2)
        return z, z


def born_tables(pair):
    """1/rho and the force prefactors; no shift offset (the styles that
    shift set their own)."""
    a, rho, sigma, c, d = pair.params
    with np.errstate(divide="ignore", invalid="ignore"):
        pair.rhoinv = np.where(rho > 0, 1.0 / np.where(rho > 0, rho, 1),
                               0.0)
    pair.born1 = a * pair.rhoinv
    pair.born2 = 6.0 * c
    pair.born3 = 8.0 * d
    pair.offset = np.zeros_like(a)


@register_pair("born")
class PairBorn(SimpleTablePair):
    """Born-Mayer-Huggins: E = A e^{(sigma-r)/rho} - C/r^6 + D/r^8
    (src/pair_born.cpp)."""

    name = "born"
    ncoeff = 5  # a, rho, sigma, c, d

    def derive(self):
        born_tables(self)
        a, rho, sigma, c, d = self.params
        if self.shift:
            rc = np.where(self.cut > 0, self.cut, 1.0)
            self.offset = np.where(
                self.cut > 0, a * np.exp((sigma - rc) * self.rhoinv)
                - c / rc ** 6 + d / rc ** 8, 0)

    def pair_fn(self, r2, it, jt):
        a, rhoinv, sigma, c, d, b1, b2, b3, off, cutsq = self.pair_coeffs(
            r2, it, jt, "p0", "rhoinv", "p2", "p3", "p4", "born1", "born2",
            "born3", "offset", "cutsq")
        inside = r2 < cutsq
        r = torch.sqrt(r2)
        r2inv = 1.0 / r2
        r6inv = r2inv * r2inv * r2inv
        rexp = torch.exp((sigma - r) * rhoinv)
        forceborn = b1 * r * rexp - b2 * r6inv + b3 * r6inv * r2inv
        fpair = torch.where(inside, forceborn * r2inv, 0.0)
        e = torch.where(inside,
                        a * rexp - c * r6inv + d * r6inv * r2inv - off, 0.0)
        return fpair, e


@register_pair("lj/expand")
class PairLJExpand(SimpleTablePair):
    """Shifted-core LJ: E = 4 eps[(s/(r-delta))^12 - (s/(r-delta))^6]
    (src/pair_lj_expand.cpp)."""

    name = "lj/expand"
    ncoeff = 3  # epsilon, sigma, delta

    def derive(self):
        eps, sig, delta = self.params
        # PairLJExpand::init_one returns cut + shift: the interaction
        # range extends past the nominal cutoff by the core shift
        self.cutsq = np.where(self.cut > 0, (self.cut + delta) ** 2, 0.0)
        lj_tables(self)
        if self.shift:
            rc = np.where(self.cut > 0, self.cut, 1.0)
            sr6 = (sig / rc) ** 6
            self.offset = np.where(self.cut > 0,
                                   4.0 * eps * (sr6 ** 2 - sr6), 0.0)
        else:
            self.offset = np.zeros_like(eps)

    def pair_fn(self, r2, it, jt):
        delta, lj1, lj2, lj3, lj4, off, cutsq = self.pair_coeffs(
            r2, it, jt, "p2", "lj1", "lj2", "lj3", "lj4", "offset", "cutsq")
        inside = r2 < cutsq
        r = torch.sqrt(r2)
        rshift = torch.where(inside, r - delta, 1.0)
        rshift = torch.where(rshift > 0, rshift, 1e-10)
        rinv2 = 1.0 / (rshift * rshift)
        r6inv = rinv2 * rinv2 * rinv2
        forcelj = r6inv * (lj1 * r6inv - lj2)
        fpair = torch.where(inside, forcelj / rshift / r, 0.0)
        e = torch.where(inside, r6inv * (lj3 * r6inv - lj4) - off, 0.0)
        return fpair, e

    @property
    def max_cutoff(self):
        return float((self.cut + self.params[2])[1:, 1:].max())


@register_pair("coul/debye")
class PairCoulDebye(_CutOnly):
    """Screened Coulomb: E = qq/r e^{-kappa r} (src/pair_coul_debye.cpp)."""

    name = "coul/debye"

    def settings(self, kappa, cut_global):
        self.kappa = float(kappa)
        self.cut_global = float(cut_global)
        self._setflag[1:, 1:] = True
        self.cut[:, :] = self.cut_global

    def coeff(self, ilo, ihi, jlo, jhi, *vals):
        cut = float(vals[0]) if vals else self.cut_global
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.cut[i, j] = self.cut[j, i] = cut
                self._setflag[i, j] = True

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        qqrd2e = self.units.qqr2e
        (cutsq,) = self.pair_coeffs(r2, it, jt, "cutsq")
        inside = r2 < cutsq
        r = torch.sqrt(r2)
        rinv = 1.0 / r
        screening = torch.exp(-self.kappa * r)
        forcecoul = qqrd2e * qi * qj * screening * (self.kappa + rinv)
        fpair = torch.where(inside, w_coul * forcecoul * rinv * rinv, 0.0)
        ecoul = torch.where(inside,
                            w_coul * qqrd2e * qi * qj * rinv * screening, 0.0)
        return fpair, torch.zeros_like(fpair), ecoul, None
