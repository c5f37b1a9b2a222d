"""The second wave of pairwise styles: coul/long, coul/dsf, coul/wolf,
zbl, buck/coul/cut, buck/coul/long, born/coul/long, born/coul/wolf,
born/coul/dsf, lj/class2 (/coul/cut, /coul/long), nm/cut, mie/cut,
lj/gromacs, lj/smooth/linear, harmonic/cut, lj/cut/coul/wolf and
lj/cut/coul/dsf.

PyTorch counterpart of tpumd/models/pair_breadth2.py, on the matrix
neighbor engine through ``pair_sums``; physics per the reference kernels
cited on each class.  The Wolf and DSF styles have a Coulomb self-energy
per atom, which LAMMPS tallies with ev_tally(i, i, ...)
(src/pair_coul_dsf.cpp:37): ``ecoul_self_atom(q)`` gives it per atom, and
the force evaluation adds its sum to ecoul, as pe/atom adds each atom's to
its own energy.
"""

from __future__ import annotations

from math import erfc, exp

import numpy as np
import torch

from tpumd_torch.models.base import SimpleTablePair
from tpumd_torch.models.pair_misc import A1, A2, A3, A4, A5, EWALD_P, \
    CoulCutoff, PairBuck, born_tables, coul_cut_terms, coul_long_terms, \
    lj_tables, lj_terms
from tpumd_torch.models.registry import register_pair

MY_PIS = float(np.sqrt(np.pi))


class _GlobalCoul(SimpleTablePair):
    """A Coulomb-only style: settings(..., cut_coul), pair_coeff * *."""

    ncoeff = 0

    def coeff(self, ilo, ihi, jlo, jhi, *vals):
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.cut[i, j] = self.cut_global
                self._setflag[i, j] = True

    @property
    def max_cutoff(self):
        return self.cut_coul


class _SelfEnergy:
    """The Wolf and DSF self-energy -(e_shift/2 + alpha/sqrt(pi)) q_i^2
    qqrd2e of each atom (src/pair_coul_dsf.cpp:37)."""

    def ecoul_self_atom(self, q):
        return -(self.e_shift / 2.0 + self.alf / MY_PIS) * q * q \
            * self.units.qqr2e


def wolf_shifts(pair):
    rc = pair.cut_coul
    pair.cut_coulsq = rc * rc
    pair.e_shift = erfc(pair.alf * rc) / rc
    pair.f_shift = -(pair.e_shift + 2.0 * pair.alf / MY_PIS
                     * exp(-pair.alf * pair.alf * rc * rc)) / rc


def dsf_shifts(pair):
    # init_style :209-212: the shifts from the true erfc at the cutoff
    rc = pair.cut_coul
    pair.cut_coulsq = rc * rc
    erfcc = erfc(pair.alf * rc)
    erfcd = exp(-pair.alf * pair.alf * rc * rc)
    pair.f_shift = -(erfcc / pair.cut_coulsq
                     + 2.0 / MY_PIS * pair.alf * erfcd / rc)
    pair.e_shift = erfcc / rc - pair.f_shift * rc


def wolf_terms(pair, r2, w_coul, qi, qj):
    """(ecoul, fcoul) of Wolf-summed Coulomb, the true erfc
    (src/pair_coul_wolf.cpp)."""
    in_c = r2 < pair.cut_coulsq
    r = torch.sqrt(r2)
    prefactor = pair.units.qqr2e * qi * qj / r
    erfcc = torch.special.erfc(pair.alf * r)
    erfcd = torch.exp(-pair.alf * pair.alf * r2)
    v_sh = (erfcc - pair.e_shift * r) * prefactor
    dvdrr = (erfcc / r2 + 2.0 * pair.alf / MY_PIS * erfcd / r) \
        + pair.f_shift
    forcecoul = dvdrr * r2 * prefactor - (1.0 - w_coul) * prefactor
    ec = v_sh - (1.0 - w_coul) * prefactor
    return (torch.where(in_c, ec, 0.0),
            torch.where(in_c, forcecoul / r2, 0.0))


def dsf_terms(pair, r2, w_coul, qi, qj, true_erfc: bool):
    """(ecoul, fcoul) of damped-shifted-force Coulomb: the erfc
    polynomial (coul/dsf, lj/cut/coul/dsf) or the true erfc
    (born/coul/dsf, src/EXTRA-PAIR/pair_born_coul_dsf.cpp:135-137)."""
    in_c = r2 < pair.cut_coulsq
    r = torch.sqrt(r2)
    prefactor = pair.units.qqr2e * qi * qj / r
    erfcd = torch.exp(-pair.alf * pair.alf * r2)
    if true_erfc:
        erfcc = torch.special.erfc(pair.alf * r)
    else:
        t = 1.0 / (1.0 + EWALD_P * pair.alf * r)
        erfcc = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * erfcd
    forcecoul = prefactor * (erfcc / r + 2.0 * pair.alf / MY_PIS * erfcd
                             + r * pair.f_shift) * r
    forcecoul = forcecoul - (1.0 - w_coul) * prefactor
    ec = prefactor * (erfcc - r * pair.e_shift - r2 * pair.f_shift) \
        - (1.0 - w_coul) * prefactor
    return (torch.where(in_c, ec, 0.0),
            torch.where(in_c, forcecoul / r2, 0.0))


@register_pair("coul/long")
class PairCoulLong(_GlobalCoul):
    """Ewald-erfc real-space Coulomb only (src/KSPACE/pair_coul_long.cpp);
    pair_coeff takes no parameters, the cutoff is global."""

    name = "coul/long"
    g_ewald = 0.0

    def settings(self, cut_coul):
        self.cut_global = float(cut_coul)
        self.cut_coul = float(cut_coul)

    def derive(self):
        self.cut_coulsq = self.cut_coul ** 2

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        ec, fcoul = coul_long_terms(self, r2, w_coul, qi, qj)
        z = torch.zeros_like(r2)
        return z, z, ec, fcoul


@register_pair("coul/dsf")
class PairCoulDSF(_SelfEnergy, _GlobalCoul):
    """Damped-shifted-force Coulomb (src/pair_coul_dsf.cpp:95-215,
    Fennell & Gezelter JCP 124, 234104)."""

    name = "coul/dsf"

    def settings(self, alpha, cut_coul):
        self.alf = float(alpha)
        self.cut_global = float(cut_coul)
        self.cut_coul = float(cut_coul)

    def derive(self):
        dsf_shifts(self)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        ec, fcoul = dsf_terms(self, r2, w_coul, qi, qj, False)
        z = torch.zeros_like(r2)
        return z, z, ec, fcoul


@register_pair("coul/wolf")
class PairCoulWolf(_SelfEnergy, _GlobalCoul):
    """Wolf-summation Coulomb (src/pair_coul_wolf.cpp, Wolf et al JCP 110,
    8254), the true erfc as the reference has it."""

    name = "coul/wolf"

    def settings(self, alf, cut_coul):
        self.alf = float(alf)
        self.cut_global = float(cut_coul)
        self.cut_coul = float(cut_coul)

    def derive(self):
        wolf_shifts(self)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        ec, fcoul = wolf_terms(self, r2, w_coul, qi, qj)
        z = torch.zeros_like(r2)
        return z, z, ec, fcoul


# ZBL universal screening constants (src/pair_zbl_const.h)
_Z_PZBL, _Z_A0 = 0.23, 0.46850
_Z_C = (0.02817, 0.28022, 0.50986, 0.18175)
_Z_D = (0.20162, 0.40290, 0.94229, 3.19980)


@register_pair("zbl")
class PairZBL(SimpleTablePair):
    """Ziegler-Biersack-Littmark screened nuclear repulsion with the
    smooth inner/outer switching (src/pair_zbl.cpp:95-150, set_coeff
    :440-).  coeff: Z_i Z_j; settings: cut_inner cut_global."""

    name = "zbl"
    ncoeff = 1  # z

    def settings(self, cut_inner, cut_global):
        self.cut_inner = float(cut_inner)
        self.cut_global = float(cut_global)

    def coeff(self, ilo, ihi, jlo, jhi, zi, zj=None):
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.params[0, i, j] = zi
                # z_one/z_two: the diagonal sets z[i]; init mixes z[i], z[j]
                self.params[0, j, i] = zj if zj is not None else zi
                self.cut[i, j] = self.cut_global
                self._setflag[i, j] = True
        if zj is not None and ilo == jlo:
            self.params[0, ilo, ilo] = zi

    def init(self):
        nt = self.ntypes
        z = np.zeros(nt + 1)
        for i in range(1, nt + 1):
            if self._setflag[i, i]:
                z[i] = self.params[0, i, i]
        zi_t = np.zeros((nt + 1, nt + 1))
        zj_t = np.zeros((nt + 1, nt + 1))
        for i in range(1, nt + 1):
            for j in range(1, nt + 1):
                if self._setflag[i, j] or self._setflag[j, i]:
                    zi_t[i, j] = self.params[0, i, j]
                    zj_t[i, j] = self.params[0, j, i]
                else:
                    zi_t[i, j], zj_t[i, j] = z[i], z[j]
        # set_coeff: ZBL tables (units enter via angstrom and qelectron)
        u = self.units
        ainv = (zi_t ** _Z_PZBL + zj_t ** _Z_PZBL) / (_Z_A0 * u.angstrom)
        d_a = [d * ainv for d in _Z_D]
        for k, da in enumerate(d_a):
            setattr(self, f"d_a{k}", da)
        self.zze = zi_t * zj_t * u.qqr2e * u.qelectron * u.qelectron

        def e_zbl(r):
            s = sum(c * np.exp(-da * r) for c, da in zip(_Z_C, d_a))
            return self.zze * s / r

        def dzbldr(r):
            es = [np.exp(-da * r) for da in d_a]
            s = sum(c * e for c, e in zip(_Z_C, es))
            sp = -sum(c * da * e for c, da, e in zip(_Z_C, d_a, es))
            return self.zze * (sp - s / r) / r

        def d2zbldr2(r):
            es = [np.exp(-da * r) for da in d_a]
            s = sum(c * e for c, e in zip(_Z_C, es))
            sp = sum(c * e * da for c, da, e in zip(_Z_C, d_a, es))
            spp = sum(c * e * da * da for c, da, e in zip(_Z_C, d_a, es))
            return self.zze * (spp + 2.0 * sp / r + 2.0 * s / (r * r)) / r

        tc = self.cut_global - self.cut_inner
        fc = e_zbl(self.cut_global)
        fcp = dzbldr(self.cut_global)
        fcpp = d2zbldr2(self.cut_global)
        swa = (-3.0 * fcp + tc * fcpp) / (tc * tc)
        swb = (2.0 * fcp - tc * fcpp) / (tc ** 3)
        self.sw1, self.sw2 = swa, swb
        self.sw3, self.sw4 = swa / 3.0, swb / 4.0
        self.sw5 = -fc + (tc / 2.0) * fcp - (tc * tc / 12.0) * fcpp
        self.cutsq = np.full((nt + 1, nt + 1), self.cut_global ** 2)
        self.drop_tables()

    @property
    def max_cutoff(self):
        return self.cut_global

    def pair_fn(self, r2, it, jt):
        *d_a, zze, sw1, sw2, sw3, sw4, sw5 = self.pair_coeffs(
            r2, it, jt, "d_a0", "d_a1", "d_a2", "d_a3", "zze", "sw1", "sw2",
            "sw3", "sw4", "sw5")
        inside = r2 < self.cut_global ** 2
        r = torch.sqrt(r2)
        es = [torch.exp(-da * r) for da in d_a]
        ssum = sum(c * e for c, e in zip(_Z_C, es))
        sp = -sum(c * da * e for c, da, e in zip(_Z_C, d_a, es))
        dzbl = zze * (sp - ssum / r) / r
        ezbl = zze * ssum / r
        t = r - self.cut_inner
        outer = r2 > self.cut_inner ** 2
        fpair = dzbl + torch.where(outer, t * t * (sw1 + sw2 * t), 0.0)
        fpair = torch.where(inside, -fpair / r, 0.0)
        e = ezbl + sw5 + torch.where(outer, t ** 3 * (sw3 + sw4 * t), 0.0)
        return fpair, torch.where(inside, e, 0.0)


@register_pair("buck/coul/cut")
class PairBuckCoulCut(CoulCutoff, PairBuck):
    """Buckingham + truncated Coulomb (src/pair_buck_coul_cut.cpp)."""

    name = "buck/coul/cut"

    def derive(self):
        self.cut_coulsq = self.cut_coul ** 2

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fb, eb = PairBuck.pair_fn(self, r2, it, jt)
        ec, fcoul = coul_cut_terms(self, r2, w_coul, qi, qj)
        return w_lj * fb, w_lj * eb, ec, fcoul


@register_pair("buck/coul/long")
class PairBuckCoulLong(PairBuckCoulCut):
    """Buckingham + Ewald-erfc Coulomb
    (src/KSPACE/pair_buck_coul_long.cpp)."""

    name = "buck/coul/long"
    g_ewald = 0.0

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fb, eb = PairBuck.pair_fn(self, r2, it, jt)
        ec, fcoul = coul_long_terms(self, r2, w_coul, qi, qj)
        return w_lj * fb, w_lj * eb, ec, fcoul


class _Born(SimpleTablePair):
    """Born-Mayer-Huggins repulsion for the Coulomb combinations
    (src/KSPACE/pair_born_coul_long.cpp, src/EXTRA-PAIR/
    pair_born_coul_{wolf,dsf}.cpp)."""

    ncoeff = 5  # a rho sigma c d

    def born_terms(self, r2, it, jt, w_lj):
        a, rhoinv, sig, c, d, offset, cutsq = self.pair_coeffs(
            r2, it, jt, "p0", "rhoinv", "p2", "p3", "p4", "offset", "cutsq")
        in_r = r2 < cutsq
        r2inv = 1.0 / r2
        r6inv = r2inv ** 3
        r = torch.sqrt(r2)
        rexp = torch.exp((sig - r) * rhoinv)
        forceborn = (a * rhoinv * r * rexp - 6.0 * c * r6inv
                     + 8.0 * d * r2inv * r6inv)
        e = a * rexp - c * r6inv + d * r6inv * r2inv - offset
        return (torch.where(in_r, w_lj * forceborn * r2inv, 0.0),
                torch.where(in_r, w_lj * e, 0.0))


@register_pair("born/coul/long")
class PairBornCoulLong(CoulCutoff, _Born):
    """Born-Mayer-Huggins + Ewald-erfc Coulomb
    (src/KSPACE/pair_born_coul_long.cpp)."""

    name = "born/coul/long"
    g_ewald = 0.0

    def derive(self):
        born_tables(self)
        a, rho, sig, c, d = self.params
        self.cut_coulsq = self.cut_coul ** 2
        if self.shift:
            rho_s = np.where(rho > 0, rho, 1.0)
            rc = np.where(self.cut > 0, self.cut, 1.0)
            self.offset = np.where(
                self.cut > 0,
                a * np.exp((sig - rc) / rho_s) - c / rc ** 6 + d / rc ** 8,
                0.0)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = self.born_terms(r2, it, jt, w_lj)
        ec, fcoul = coul_long_terms(self, r2, w_coul, qi, qj)
        return fpair, e, ec, fcoul


class _LJ96(SimpleTablePair):
    """COMPASS 9-6 LJ (src/CLASS2/pair_lj_class2.cpp:509-527):
    sixthpower epsilon/sigma mixing always."""

    ncoeff = 2  # epsilon sigma

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.mix = "sixthpower"

    def init(self):
        nt = self.ntypes
        eps, sig = self.params[0], self.params[1]
        for i in range(1, nt + 1):
            for j in range(i, nt + 1):
                if not self._setflag[i, j]:
                    # always sixthpower for eps and sigma (:509)
                    e1, e2 = eps[i, i], eps[j, j]
                    s1, s2 = sig[i, i], sig[j, j]
                    eps[i, j] = (2.0 * np.sqrt(e1 * e2) * s1 ** 3 * s2 ** 3) \
                        / (s1 ** 6 + s2 ** 6) if (s1 ** 6 + s2 ** 6) else 0.0
                    sig[i, j] = (0.5 * (s1 ** 6 + s2 ** 6)) ** (1.0 / 6.0)
                    self.cut[i, j] = self.cut_global
                self.params[:, j, i] = self.params[:, i, j]
                self.cut[j, i] = self.cut[i, j]
        self.cutsq = self.cut * self.cut
        self.derive()
        self.drop_tables()

    def derive(self):
        eps, sig = self.params[0], self.params[1]
        self.lj1 = 18.0 * eps * sig ** 9
        self.lj2 = 18.0 * eps * sig ** 6
        self.lj3 = 2.0 * eps * sig ** 9
        self.lj4 = 3.0 * eps * sig ** 6
        if self.shift:
            rc = np.where(self.cut > 0, self.cut, 1.0)
            ratio = sig / rc
            self.offset = np.where(
                self.cut > 0, eps * (2.0 * ratio ** 9 - 3.0 * ratio ** 6),
                0.0)
        else:
            self.offset = np.zeros_like(eps)

    def lj96(self, r2, it, jt, w_lj):
        lj1, lj2, lj3, lj4, off, cutsq = self.pair_coeffs(
            r2, it, jt, "lj1", "lj2", "lj3", "lj4", "offset", "cutsq")
        in_lj = r2 < cutsq
        r2inv = 1.0 / r2
        rinv = torch.sqrt(r2inv)
        r3inv = r2inv * rinv
        r6inv = r3inv * r3inv
        forcelj = r6inv * (lj1 * r3inv - lj2)
        fpair = torch.where(in_lj, w_lj * forcelj * r2inv, 0.0)
        e = torch.where(in_lj, w_lj * (r6inv * (lj3 * r3inv - lj4) - off),
                        0.0)
        return fpair, e


@register_pair("lj/class2")
class PairLJClass2(_LJ96):
    name = "lj/class2"

    def pair_fn(self, r2, it, jt):
        return self.lj96(r2, it, jt, 1.0)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = self.lj96(r2, it, jt, w_lj)
        return fpair, e, None, None


@register_pair("lj/class2/coul/cut")
class PairLJClass2CoulCut(CoulCutoff, _LJ96):
    """9-6 LJ + truncated Coulomb (src/CLASS2/pair_lj_class2_coul_cut)."""

    name = "lj/class2/coul/cut"

    def derive(self):
        super().derive()
        self.cut_coulsq = self.cut_coul ** 2

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = self.lj96(r2, it, jt, w_lj)
        ec, fcoul = coul_cut_terms(self, r2, w_coul, qi, qj)
        return fpair, e, ec, fcoul


@register_pair("lj/class2/coul/long")
class PairLJClass2CoulLong(PairLJClass2CoulCut):
    """9-6 LJ + Ewald-erfc Coulomb (src/CLASS2/pair_lj_class2_coul_long)."""

    name = "lj/class2/coul/long"
    g_ewald = 0.0

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = self.lj96(r2, it, jt, w_lj)
        ec, fcoul = coul_long_terms(self, r2, w_coul, qi, qj)
        return fpair, e, ec, fcoul


@register_pair("nm/cut")
class PairNMCut(SimpleTablePair):
    """N-M potential E = E0/(n-m) [m(r0/r)^n - n(r0/r)^m]
    (src/EXTRA-PAIR/pair_nm_cut.cpp:110-140)."""

    name = "nm/cut"
    ncoeff = 4  # e0, r0, n, m

    def derive(self):
        e0, r0, nn, mm = self.params
        nm_diff = np.where(nn != mm, nn - mm, 1.0)
        self.e0nm = e0 / nm_diff
        self.nm = nn * mm
        self.r0n = np.where(r0 > 0, r0, 1.0) ** nn
        self.r0m = np.where(r0 > 0, r0, 1.0) ** mm
        if self.shift:
            rc = np.where(self.cut > 0, self.cut, 1.0)
            self.offset = np.where(
                self.cut > 0, self.e0nm * (mm * self.r0n / rc ** nn
                                           - nn * self.r0m / rc ** mm), 0.0)
        else:
            self.offset = np.zeros_like(e0)

    def pair_fn(self, r2, it, jt):
        nn, mm, e0nm, nm, r0n, r0m, off, cutsq = self.pair_coeffs(
            r2, it, jt, "p2", "p3", "e0nm", "nm", "r0n", "r0m", "offset",
            "cutsq")
        inside = r2 < cutsq
        r2inv = 1.0 / r2
        r = torch.sqrt(r2)
        rninv = r2inv ** (nn / 2.0)
        rminv = r2inv ** (mm / 2.0)
        forcenm = e0nm * nm * (r0n / r ** nn - r0m / r ** mm)
        fpair = torch.where(inside, forcenm * r2inv, 0.0)
        e = torch.where(inside,
                        e0nm * (mm * r0n * rninv - nn * r0m * rminv) - off,
                        0.0)
        return fpair, e


@register_pair("mie/cut")
class PairMIECut(SimpleTablePair):
    """Mie potential (src/EXTRA-PAIR/pair_mie_cut.cpp:110-140)."""

    name = "mie/cut"
    ncoeff = 4  # epsilon, sigma, gammaR, gammaA

    def derive(self):
        eps, sig, gr, ga = self.params
        diff = np.where(gr != ga, gr - ga, 1.0)
        ratio = np.where(ga != 0, gr / np.where(ga != 0, ga, 1.0), 1.0)
        cmie = gr / diff * ratio ** (ga / diff)
        sig_s = np.where(sig > 0, sig, 1.0)
        self.mie1 = cmie * gr * eps * sig_s ** gr
        self.mie2 = cmie * ga * eps * sig_s ** ga
        self.mie3 = cmie * eps * sig_s ** gr
        self.mie4 = cmie * eps * sig_s ** ga
        if self.shift:
            rc = np.where(self.cut > 0, self.cut, 1.0)
            ratio_c = sig_s / rc
            self.offset = np.where(
                self.cut > 0, cmie * eps * (ratio_c ** gr - ratio_c ** ga),
                0.0)
        else:
            self.offset = np.zeros_like(eps)

    def pair_fn(self, r2, it, jt):
        gr, ga, m1, m2, m3, m4, off, cutsq = self.pair_coeffs(
            r2, it, jt, "p2", "p3", "mie1", "mie2", "mie3", "mie4", "offset",
            "cutsq")
        inside = r2 < cutsq
        r2inv = 1.0 / r2
        rgam_a = r2inv ** (ga / 2.0)
        rgam_r = r2inv ** (gr / 2.0)
        forcemie = m1 * rgam_r - m2 * rgam_a
        fpair = torch.where(inside, forcemie * r2inv, 0.0)
        e = torch.where(inside, m3 * rgam_r - m4 * rgam_a - off, 0.0)
        return fpair, e


@register_pair("lj/gromacs")
class PairLJGromacs(SimpleTablePair):
    """LJ with GROMACS force switching between the inner and outer
    cutoffs (src/EXTRA-PAIR/pair_lj_gromacs.cpp:110-145, :268-287)."""

    name = "lj/gromacs"
    ncoeff = 2  # epsilon sigma

    def settings(self, cut_inner, cut_global):
        self.cut_inner_g = float(cut_inner)
        self.cut_global = float(cut_global)

    def derive(self):
        lj_tables(self)
        rc = np.where(self.cut > 0, self.cut, 1.0)
        ri = np.full_like(rc, self.cut_inner_g)
        r6inv = 1.0 / rc ** 6
        r8inv = 1.0 / rc ** 8
        t = rc - ri
        t = np.where(t > 0, t, 1.0)
        t2inv = 1.0 / (t * t)
        t3inv = t2inv / t
        t3 = 1.0 / t3inv
        a6 = (7.0 * ri - 10.0 * rc) * r8inv * t2inv
        b6 = (9.0 * rc - 7.0 * ri) * r8inv * t3inv
        a12 = (13.0 * ri - 16.0 * rc) * r6inv * r8inv * t2inv
        b12 = (15.0 * rc - 13.0 * ri) * r6inv * r8inv * t3inv
        c6 = r6inv - t3 * (6.0 * a6 / 3.0 + 6.0 * b6 * t / 4.0)
        c12 = r6inv * r6inv - t3 * (12.0 * a12 / 3.0 + 12.0 * b12 * t / 4.0)
        self.ljsw1 = self.lj1 * a12 - self.lj2 * a6
        self.ljsw2 = self.lj1 * b12 - self.lj2 * b6
        self.ljsw3 = -self.lj3 * 12.0 * a12 / 3.0 + self.lj4 * 6.0 * a6 / 3.0
        self.ljsw4 = -self.lj3 * 12.0 * b12 / 4.0 + self.lj4 * 6.0 * b6 / 4.0
        self.ljsw5 = -self.lj3 * c12 + self.lj4 * c6

    def pair_fn(self, r2, it, jt):
        cutsq, lj1, lj2, lj3, lj4, sw1, sw2, sw3, sw4, sw5 = \
            self.pair_coeffs(r2, it, jt, "cutsq", "lj1", "lj2", "lj3", "lj4",
                             "ljsw1", "ljsw2", "ljsw3", "ljsw4", "ljsw5")
        inside = r2 < cutsq
        r2inv = 1.0 / r2
        r6inv = r2inv ** 3
        forcelj = r6inv * (lj1 * r6inv - lj2)
        r = torch.sqrt(r2)
        t = r - self.cut_inner_g
        outer = r2 > self.cut_inner_g ** 2
        forcelj = forcelj + torch.where(outer, r * t * t * (sw1 + sw2 * t),
                                        0.0)
        fpair = torch.where(inside, forcelj * r2inv, 0.0)
        e = r6inv * (lj3 * r6inv - lj4) + sw5
        e = e + torch.where(outer, t ** 3 * (sw3 + sw4 * t), 0.0)
        return fpair, torch.where(inside, e, 0.0)


@register_pair("lj/smooth/linear")
class PairLJSmoothLinear(SimpleTablePair):
    """LJ shifted so that E and F vanish at the cutoff
    (src/EXTRA-PAIR/pair_lj_smooth_linear.cpp:100-130, :235-241)."""

    name = "lj/smooth/linear"
    ncoeff = 2  # epsilon sigma

    def derive(self):
        lj_tables(self)
        rc = np.where(self.cut > 0, self.cut, 1.0)
        cut6inv = 1.0 / rc ** 6
        cutinv = 1.0 / rc
        self.ljcut = cut6inv * (self.lj3 * cut6inv - self.lj4)
        self.dljcut = cutinv * cut6inv * (self.lj1 * cut6inv - self.lj2)

    def pair_fn(self, r2, it, jt):
        cutsq, lj1, lj2, lj3, lj4, ljc, dljc, rcut = self.pair_coeffs(
            r2, it, jt, "cutsq", "lj1", "lj2", "lj3", "lj4", "ljcut",
            "dljcut", "cut")
        inside = r2 < cutsq
        r2inv = 1.0 / r2
        r6inv = r2inv ** 3
        rinv = torch.sqrt(r2inv)
        forcelj = r6inv * (lj1 * r6inv - lj2)
        forcelj = rinv * forcelj - dljc
        fpair = torch.where(inside, forcelj * rinv, 0.0)
        r = torch.sqrt(r2)
        e = r6inv * (lj3 * r6inv - lj4) - ljc + (r - rcut) * dljc
        return fpair, torch.where(inside, e, 0.0)


@register_pair("harmonic/cut")
class PairHarmonicCut(SimpleTablePair):
    """Repulsive-only harmonic spring E = k (rc - r)^2
    (src/EXTRA-PAIR/pair_harmonic_cut.cpp)."""

    name = "harmonic/cut"
    ncoeff = 1  # k

    def settings(self):
        self.cut_global = 0.0  # cutoffs are per coefficient

    def coeff(self, ilo, ihi, jlo, jhi, k, cut):
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.params[0, i, j] = k
                self.cut[i, j] = cut
                self._setflag[i, j] = True

    def init(self):
        nt = self.ntypes
        k = self.params[0]
        for i in range(1, nt + 1):
            for j in range(i, nt + 1):
                if not self._setflag[i, j]:
                    # init_one: k mixed geometric, cut arithmetic
                    k[i, j] = np.sqrt(k[i, i] * k[j, j])
                    self.cut[i, j] = 0.5 * (self.cut[i, i] + self.cut[j, j])
                self.params[:, j, i] = self.params[:, i, j]
                self.cut[j, i] = self.cut[i, j]
        self.cutsq = self.cut * self.cut
        self.drop_tables()

    def pair_fn(self, r2, it, jt):
        k, rc, cutsq = self.pair_coeffs(r2, it, jt, "p0", "cut", "cutsq")
        inside = r2 < cutsq
        r = torch.sqrt(r2)
        delta = rc - r
        fpair = torch.where(inside, 2.0 * k * delta / r, 0.0)
        e = torch.where(inside, k * delta * delta, 0.0)
        return fpair, e


class _DampedCoulomb(_SelfEnergy, SimpleTablePair):
    """settings(alpha, cut_lj [cut_coul]) of the Wolf and DSF
    combinations (src/EXTRA-PAIR/pair_lj_cut_coul_{wolf,dsf}.cpp,
    pair_born_coul_{wolf,dsf}.cpp)."""

    def settings(self, alf, cut_lj, cut_coul=None):
        self.alf = float(alf)
        self.cut_global = float(cut_lj)
        self.cut_coul = (float(cut_coul) if cut_coul is not None
                         else float(cut_lj))

    @property
    def max_cutoff(self):
        return max(float(self.cut[1:, 1:].max()), self.cut_coul)


@register_pair("lj/cut/coul/wolf")
class PairLJCutCoulWolf(_DampedCoulomb):
    """LJ 12-6 + Wolf-summed Coulomb
    (src/EXTRA-PAIR/pair_lj_cut_coul_wolf.cpp:76-200)."""

    name = "lj/cut/coul/wolf"
    ncoeff = 2  # epsilon sigma

    def derive(self):
        lj_tables(self)
        wolf_shifts(self)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = lj_terms(self, r2, it, jt, w_lj)
        ec, fc = wolf_terms(self, r2, w_coul, qi, qj)
        return fpair, e, ec, fc


@register_pair("lj/cut/coul/dsf")
class PairLJCutCoulDSF(_DampedCoulomb):
    """LJ 12-6 + damped-shifted-force Coulomb
    (src/EXTRA-PAIR/pair_lj_cut_coul_dsf.cpp:85-215)."""

    name = "lj/cut/coul/dsf"
    ncoeff = 2  # epsilon sigma

    def derive(self):
        lj_tables(self)
        dsf_shifts(self)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = lj_terms(self, r2, it, jt, w_lj)
        ec, fc = dsf_terms(self, r2, w_coul, qi, qj, False)
        return fpair, e, ec, fc


@register_pair("born/coul/wolf")
class PairBornCoulWolf(_DampedCoulomb, _Born):
    name = "born/coul/wolf"

    def derive(self):
        born_tables(self)
        wolf_shifts(self)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = self.born_terms(r2, it, jt, w_lj)
        ec, fc = wolf_terms(self, r2, w_coul, qi, qj)
        return fpair, e, ec, fc


@register_pair("born/coul/dsf")
class PairBornCoulDSF(_DampedCoulomb, _Born):
    name = "born/coul/dsf"

    def derive(self):
        born_tables(self)
        dsf_shifts(self)

    def pair_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        fpair, e = self.born_terms(r2, it, jt, w_lj)
        ec, fc = dsf_terms(self, r2, w_coul, qi, qj, True)
        return fpair, e, ec, fc
