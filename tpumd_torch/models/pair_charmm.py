"""CHARMM pair style lj/charmm/coul/long.

Physics per the reference (src/KSPACE/pair_lj_charmm_coul_long.cpp:37,
143-158), as tpumd/models/pair_charmm.py has it: LJ with the CHARMM
energy switch between the inner and outer cutoffs, and real-space Ewald
Coulomb through the reference's erfc polynomial.  The special-bond weights
are applied in the sweep; an excluded Coulomb pair keeps the kspace
compensation term.  The 1-4 tables (eps14, sigma14) serve the CHARMM
dihedral's 1-4 pairs.  Forces go through the cell-grid kernel
``ops/charmm_cellgrid.py`` (its plain version on the CPU).
lj/charmm/coul/charmm is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.charmm_cellgrid import CharmmCoeffs, charmm_cellgrid, \
    charmm_pair_fn


@register_pair("lj/charmm/coul/long")
class PairLJCharmmCoulLong(PairStyle):
    name = "lj/charmm/coul/long"
    # its matrix-engine pair_fn_ex (tpumd/models/pair_charmm.py:140) is not
    # ported
    matrix_engine = False
    # the pair sweep takes charges and special lists
    charged = True

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        self.mix = "arithmetic"     # CHARMM's default (Pair::mix_flag)
        shape = (ntypes + 1, ntypes + 1)
        self.epsilon = np.zeros(shape)
        self.sigma = np.zeros(shape)
        self.eps14 = np.zeros(shape)
        self.sigma14 = np.zeros(shape)
        self.g_ewald = 0.0   # set by the kspace solver at init
        self._coeffs = {}

    def settings(self, cut_lj_inner, cut_lj, cut_coul=None):
        self.cut_lj_inner = float(cut_lj_inner)
        self.cut_lj = float(cut_lj)
        self.cut_coul = (float(cut_coul) if cut_coul is not None
                         else self.cut_lj)

    def coeff(self, ilo, ihi, jlo, jhi, epsilon, sigma, eps14=None,
              sigma14=None):
        eps14 = epsilon if eps14 is None else eps14
        sigma14 = sigma if sigma14 is None else sigma14
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.epsilon[i, j] = epsilon
                self.sigma[i, j] = sigma
                self.eps14[i, j] = eps14
                self.sigma14[i, j] = sigma14
                self._setflag[i, j] = True

    def coeff_from_data(self, rows):
        """Pair Coeffs section of a data file: type eps sigma [eps14
        sigma14]."""
        for r in rows:
            t = int(r[0])
            vals = [float(v) for v in r[1:]]
            if len(vals) == 2:
                vals = vals + vals
            self.epsilon[t, t], self.sigma[t, t] = vals[0], vals[1]
            self.eps14[t, t], self.sigma14[t, t] = vals[2], vals[3]
            self._setflag[t, t] = True

    def init(self):
        nt = self.ntypes
        for i in range(1, nt + 1):
            for j in range(i, nt + 1):
                if not self._setflag[i, j]:
                    if not (self._setflag[i, i] and self._setflag[j, j]):
                        raise ValueError(
                            f"All pair coeffs are not set ({i},{j})")
                    self.epsilon[i, j] = self.mix_energy(
                        self.epsilon[i, i], self.epsilon[j, j],
                        self.sigma[i, i], self.sigma[j, j])
                    self.sigma[i, j] = self.mix_distance(
                        self.sigma[i, i], self.sigma[j, j])
                    self.eps14[i, j] = self.mix_energy(
                        self.eps14[i, i], self.eps14[j, j],
                        self.sigma14[i, i], self.sigma14[j, j])
                    self.sigma14[i, j] = self.mix_distance(
                        self.sigma14[i, i], self.sigma14[j, j])
                for arr in (self.epsilon, self.sigma, self.eps14,
                            self.sigma14):
                    arr[j, i] = arr[i, j]
        eps, sig = self.epsilon, self.sigma
        self.lj1 = 48.0 * eps * sig**12
        self.lj2 = 24.0 * eps * sig**6
        self.lj3 = 4.0 * eps * sig**12
        self.lj4 = 4.0 * eps * sig**6
        e14, s14 = self.eps14, self.sigma14
        self.lj14_1 = 48.0 * e14 * s14**12
        self.lj14_2 = 24.0 * e14 * s14**6
        self.lj14_3 = 4.0 * e14 * s14**12
        self.lj14_4 = 4.0 * e14 * s14**6
        self.cut_ljsq = self.cut_lj**2
        self.cut_lj_innersq = self.cut_lj_inner**2
        self.cut_coulsq = self.cut_coul**2
        self.denom_lj = (self.cut_ljsq - self.cut_lj_innersq)**3
        self._coeffs = {}

    @property
    def max_cutoff(self) -> float:
        return max(self.cut_lj, self.cut_coul)

    def kernel_coeffs(self, like, special_lj, special_coul) -> CharmmCoeffs:
        """The sweep's coefficients in like's dtype on like's device, made
        once per set-up (g_ewald is set by the kspace solver's init).
        special_lj / special_coul: the 4 special_bonds weights, entry 0
        for code 0 (no special)."""
        key = (like.dtype, like.device, tuple(special_lj),
               tuple(special_coul), self.g_ewald)
        c = self._coeffs.get(key)
        if c is None:
            lj = torch.as_tensor(np.stack([self.lj1, self.lj2, self.lj3,
                                           self.lj4]),
                                 dtype=like.dtype, device=like.device)
            c = self._coeffs[key] = CharmmCoeffs(
                lj, float(self.units.qqr2e), float(self.g_ewald),
                float(self.cut_coulsq), float(self.cut_ljsq),
                float(self.cut_lj_innersq), float(self.denom_lj),
                tuple(float(w) for w in special_lj),
                tuple(float(w) for w in special_coul))
        return c

    def compute_cellgrid_charged(self, s, valid, cfg, special_lj,
                                 special_coul, eflag: bool, vflag: bool):
        """(f, evdwl, ecoul, virial) of the grid-ordered state s; energies
        None unless eflag, virial unless vflag."""
        if s.special_tags is None:
            raise NotImplementedError(
                "lj/charmm/coul/long without bonds (no special lists): "
                "the port's charmm kernel takes special lists")
        c = self.kernel_coeffs(s.x, special_lj, special_coul)
        return charmm_cellgrid(s.x, s.q, s.type, valid, s.tag,
                               s.special_tags, s.special_codes, s.box, cfg,
                               c, eflag, vflag)

    def pair_fn_ex(self, r2, itype, jtype, w_lj, w_coul, qi, qj):
        """(fpair, evdwl, ecoul, fcoul) per pair: the plain pair
        function (tpumd/models/pair_charmm.py::pair_fn_ex)."""
        c = self.kernel_coeffs(r2, (1.0,) * 4, (1.0,) * 4)
        return charmm_pair_fn(c)(r2, itype, jtype, w_lj, w_coul, qi, qj)
