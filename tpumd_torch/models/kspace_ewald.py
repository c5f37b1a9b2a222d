"""Classic Ewald summation (kspace_style ewald, src/KSPACE/ewald.cpp).

PyTorch counterpart of tpumd/models/kspace_ewald.py's ``Ewald``: the
same g_ewald estimate and per-dimension kmax from the rms error model,
the half-space k vectors within gsqmx, and on the device the structure
factors S(k) = sum_i q_i exp(i k.r_i) of an (N, nk) phase matrix, the
energy E = (2 pi / V) sum_k 2 |S(k)|^2 exp(-k^2/4g^2)/k^2 with the self
and neutralization terms, the forces from the gradients of S(k) and the
virial.  ``EwaldDisp`` (kspace_style ewald/disp) adds the geometric-mixing
1/r^6 dispersion to the same k sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MY_PIS = 1.77245385090551602729


class Ewald:
    style = "ewald"

    def __init__(self, accuracy_relative: float):
        self.accuracy_relative = float(accuracy_relative)
        self.g_ewald = 0.0
        self._dev = {}

    def init(self, natoms, q, prd, units, cutoff, dynamic_box=False,
             types=None, pair=None):
        """g_ewald and the k vectors (Ewald::init, setup): q the host
        charges, prd the box lengths, cutoff the pair style's Coulomb
        cutoff; types and pair, the solver interface's other inputs, are
        read by ewald/disp."""
        if dynamic_box:
            raise NotImplementedError(
                "kspace_style ewald under a barostat is not ported (its k "
                "vectors are set at set-up, as in tpumd)")
        self.qqrd2e = units.qqr2e
        q = np.asarray(q, np.float64)
        self.qsum = float(q.sum())
        self.qsqsum = float((q * q).sum())
        self.q2 = q2 = self.qsqsum * self.qqrd2e
        self.accuracy = acc = self.accuracy_relative * units.qqr2e
        prd = np.asarray(prd, np.float64)
        g = acc * np.sqrt(natoms * cutoff * prd.prod()) / (2.0 * q2)
        if g >= 1.0:
            g = (1.35 - 0.15 * np.log(acc)) / cutoff
        else:
            g = np.sqrt(-np.log(g)) / cutoff
        self.g_ewald = g

        def rms(km, prd_d):
            return (2.0 * q2 * g / prd_d
                    * np.sqrt(1.0 / (np.pi * km * natoms))
                    * np.exp(-np.pi ** 2 * km * km / (g * g * prd_d * prd_d)))

        kmax = []
        for d in range(3):
            km = 1
            while rms(km, prd[d]) > acc:
                km += 1
            kmax.append(km)
        self.kmax = tuple(kmax)
        unitk = 2 * np.pi / prd
        gsqmx = max((unitk[d] * kmax[d]) ** 2 for d in range(3))
        # the half space kx > 0, or kx = 0 and ky > 0, or kx = ky = 0 and
        # kz > 0, in tpumd's order
        ks = []
        for kx in range(0, kmax[0] + 1):
            for ky in range(-kmax[1] if kx > 0 else 0, kmax[1] + 1):
                kz_lo = -kmax[2] if (kx > 0 or ky != 0) else 1
                for kz in range(kz_lo, kmax[2] + 1):
                    kvec = unitk * np.array([kx, ky, kz], dtype=np.float64)
                    ksq = float(kvec @ kvec)
                    if 0 < ksq <= gsqmx:
                        ks.append((kvec, ksq))
        self.kvecs = np.array([k for k, _ in ks])
        ksq = np.array([s for _, s in ks])
        self.ug = np.exp(-0.25 * ksq / (g * g)) / ksq
        self._dev = {}

    def _tables(self, dtype, device):
        key = (dtype, device)
        if key not in self._dev:
            kv = torch.as_tensor(self.kvecs, dtype=dtype, device=device)
            self._dev[key] = (kv, torch.as_tensor(self.ug, dtype=dtype,
                                                  device=device))
        return self._dev[key]

    def compute(self, x, q, box, eflag: bool, vflag: bool, type_=None):
        """(f (N, 3), elong () or None, virial (6,) or None) of the charges
        q at positions x (type_, the rows' types, is read by
        ewald/disp)."""
        kv, ug = self._tables(x.dtype, x.device)
        vol = box.volume
        pref = 2.0 * np.pi / vol
        phase = x @ kv.T                               # (N, nk)
        c = torch.cos(phase)
        sn = torch.sin(phase)
        sr = q @ c                                     # (nk,)
        si = q @ sn
        # f_i = 2 qqrd2e pref q_i sum_k 2 ug_k k (sin(k.r_i) Sr -
        # cos(k.r_i) Si), the half space counted twice
        coef = (sn * sr - c * si) * (2.0 * ug)
        f = (2.0 * self.qqrd2e * pref) * q[:, None] * (coef @ kv)
        elong = virial = None
        sk2 = sr * sr + si * si
        if eflag:
            e = 2.0 * pref * torch.sum(ug * sk2)
            e = e - self.g_ewald * self.qsqsum / MY_PIS \
                - 0.5 * np.pi * self.qsum ** 2 / (self.g_ewald ** 2 * vol)
            elong = self.qqrd2e * e
        if vflag:
            ksq = torch.sum(kv * kv, dim=1)
            vterm = 2.0 * (1.0 / ksq + 0.25 / (self.g_ewald ** 2))
            w = ug * sk2
            virial = torch.stack([
                2.0 * pref * self.qqrd2e * torch.sum(
                    w * ((1.0 if a == b else 0.0) - vterm * kv[:, a]
                         * kv[:, b]))
                for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                             (1, 2))])
        return f, elong, virial


class EwaldDisp(Ewald):
    """kspace_style ewald/disp: Coulomb and geometric-mixing 1/r^6
    dispersion in one k sum (src/KSPACE/ewald_disp.cpp; tpumd/models/
    kspace_ewald.py:122-254).

    The dispersion structure factor S_B(k) = sum_i B_i e^{ik.x} with B_i =
    sqrt(|lj4_ii|) of the atom's type (init_coeffs :544-556), read on the
    device from a per-type table, so padded rows (type 0) add nothing; the
    per-k coefficient ke_6 = -h^3 (sqrt(pi) erfc(b) + (0.5/b^2 - 1)
    e^{-b^2}/b), b = h/(2 g) (coefficients :497-530); the energy prefactor
    2 pi sqrt(pi)/(24 V) and the self and volume corrections of init_self
    (:640-643).  The k set is EwaldDisp's: the combined Coulomb and
    dispersion rms (:352-366) and its nbox/gsqmx acceptance (:300-334,
    :385-406).  tpumd takes the dispersion forces from jax.grad of the k
    sum; here they are its analytic gradient."""

    style = "ewald/disp"

    def init(self, natoms, q, prd, units, cutoff, dynamic_box=False,
             types=None, pair=None):
        super().init(natoms, q, prd, units, cutoff, dynamic_box)
        if pair is None or not hasattr(pair, "lj4") or types is None:
            raise ValueError("kspace_style ewald/disp needs an lj/long pair "
                             f"style, not {getattr(pair, 'name', None)}")
        lj4 = np.asarray(pair.lj4, np.float64)
        self.b_type = np.sqrt(np.abs(np.diag(lj4)))
        self.b_type[0] = 0.0
        bq = self.b_type[np.asarray(types)]
        self.bsum = float(bq.sum())
        self.b2sum = float((bq ** 2).sum())
        # g_ewald_6 is g_ewald (EwaldDisp::init :285)
        g = self.g_ewald_6 = self.g_ewald
        prd = np.asarray(prd, np.float64)
        g2 = g * g
        g7 = g2 * g2 * g2 * g

        def rms(km, prd_d):
            damp = np.exp(-np.pi ** 2 * km * km / (g2 * prd_d * prd_d))
            return (2.0 * self.q2 * g / prd_d
                    * np.sqrt(1.0 / (np.pi * km * natoms)) * damp
                    + 4.0 * self.b2sum * g7 / 3.0
                    * np.sqrt(1.0 / (np.pi * natoms)) * damp
                    * (np.pi * km / (g * prd_d) + 1.0))

        kmax = []
        for d in range(3):
            km = 1
            while rms(km, prd[d]) > self.accuracy:
                km += 1
            kmax.append(km)
        nbox = max(kmax)
        unitk = 2.0 * np.pi / prd
        gsqmx = max((unitk[d] * kmax[d]) ** 2 for d in range(3)) * 1.00001
        ks = []
        for kx in range(0, nbox + 1):
            for ky in range(-nbox, nbox + 1):
                for kz in range(-nbox, nbox + 1):
                    if (kx == 0 and (ky < 0 or (ky == 0 and kz <= 0))):
                        continue
                    kvec = unitk * np.array([kx, ky, kz], np.float64)
                    ksqv = float(kvec @ kvec)
                    if ksqv <= gsqmx:
                        ks.append((kvec, ksqv))
        self.kvecs = np.array([k for k, _ in ks])
        ksq = np.array([s for _, s in ks])
        self.ug = np.exp(-0.25 * ksq / g2) / ksq
        h1 = np.sqrt(ksq)
        b = 0.5 * h1 / self.g_ewald_6
        erfc_b = np.array([math.erfc(v) for v in b])
        expb2 = np.exp(-b * b)
        self.ke6 = -h1 * ksq * (MY_PIS * erfc_b
                                + (0.5 / (b * b) - 1.0) * expb2 / b)
        self.kv6_c2 = 3.0 * h1 * (MY_PIS * erfc_b - expb2 / b)
        self._dev = {}

    def _disp_tables(self, dtype, device):
        key = ("disp", dtype, device)
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)
            self._dev[key] = (t(self.ke6), t(self.kv6_c2), t(self.b_type))
        return self._dev[key]

    def compute(self, x, q, box, eflag: bool, vflag: bool, type_=None):
        f, elong, virial = super().compute(x, q, box, eflag, vflag)
        kv, _ = self._tables(x.dtype, x.device)
        ke6, c2, b_type = self._disp_tables(x.dtype, x.device)
        bq = b_type[type_.long()]
        vol = box.volume
        g3 = self.g_ewald_6 ** 3
        # 2 pi sqrt(pi)/(24 V) carries the half space's factor 2
        c1 = 2.0 * np.pi * MY_PIS / (24.0 * vol)
        phase = x @ kv.T
        c, sn = torch.cos(phase), torch.sin(phase)
        sr, si = bq @ c, bq @ sn
        # -dE6/dx_i = 2 c1 B_i sum_k ke6_k (S_r sin_i - S_i cos_i) k
        coef = (sn * sr - c * si) * ke6
        f = f + (2.0 * c1) * bq[:, None] * (coef @ kv)
        sk2 = sr * sr + si * si
        virial_self6 = np.pi * MY_PIS * g3 / (6.0 * vol) * self.bsum ** 2
        if eflag:
            e6 = c1 * torch.sum(ke6 * sk2)
            energy_self6 = -self.b2sum * g3 * g3 / 12.0 + virial_self6
            elong = elong + e6 - energy_self6
        if vflag:
            v6 = torch.stack([
                c1 * torch.sum(((ke6 if a == b else 0.0)
                                - c2 * kv[:, a] * kv[:, b]) * sk2)
                for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                             (1, 2))])
            diag = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
                                dtype=x.dtype, device=x.device)
            virial = virial + v6 - virial_self6 * diag
        return f, elong, virial
