"""Classic Ewald summation (kspace_style ewald, src/KSPACE/ewald.cpp).

PyTorch counterpart of tpumd/models/kspace_ewald.py's ``Ewald``: the
same g_ewald estimate and per-dimension kmax from the rms error model,
the half-space k vectors within gsqmx, and on the device the structure
factors S(k) = sum_i q_i exp(i k.r_i) of an (N, nk) phase matrix, the
energy E = (2 pi / V) sum_k 2 |S(k)|^2 exp(-k^2/4g^2)/k^2 with the self
and neutralization terms, the forces from the gradients of S(k) and the
virial.  ewald/disp is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

MY_PIS = 1.77245385090551602729


class Ewald:
    style = "ewald"

    def __init__(self, accuracy_relative: float):
        self.accuracy_relative = float(accuracy_relative)
        self.g_ewald = 0.0
        self._dev = {}

    def init(self, natoms, q, prd, units, cutoff, dynamic_box=False):
        """g_ewald and the k vectors (Ewald::init, setup): q the host
        charges, prd the box lengths, cutoff the pair style's Coulomb
        cutoff."""
        if dynamic_box:
            raise NotImplementedError(
                "kspace_style ewald under a barostat is not ported (its k "
                "vectors are set at set-up, as in tpumd)")
        self.qqrd2e = units.qqr2e
        q = np.asarray(q, np.float64)
        self.qsum = float(q.sum())
        self.qsqsum = float((q * q).sum())
        q2 = self.qsqsum * self.qqrd2e
        acc = self.accuracy_relative * units.qqr2e
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

    def compute(self, x, q, box, eflag: bool, vflag: bool):
        """(f (N, 3), elong () or None, virial (6,) or None) of the charges
        q at positions x."""
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
