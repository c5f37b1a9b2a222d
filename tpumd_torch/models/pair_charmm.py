"""CHARMM pair styles lj/charmm/coul/long and lj/charmm/coul/charmm.

Physics per the reference (src/KSPACE/pair_lj_charmm_coul_long.cpp:37,
143-158; src/MOLECULE/pair_lj_charmm_coul_charmm.cpp), as
tpumd/models/pair_charmm.py has it: LJ with the CHARMM energy switch
between the inner and outer cutoffs, and real-space Ewald Coulomb through
the reference's erfc polynomial (coul/long) or Coulomb under the same
switch (coul/charmm).  The special-bond weights are applied in the sweep by
each list entry's code; an excluded Coulomb pair keeps the kspace
compensation term.  The 1-4 tables (eps14, sigma14) serve the CHARMM
dihedral's 1-4 pairs.  On the cell grid lj/charmm/coul/long sweeps the
grid's pair list: forces go through the kernel of
``ops/charmm_cellgrid.py`` (its plain version on the CPU).  On the matrix
neighbor engine both styles run through ``pair_fn_ex`` and ``pair_sums``;
lj/charmm/coul/charmm runs there only.
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
    # B5 takes it on the cell grid, sweeping charges and special lists (the
    # grid's pair list carries the special codes)
    supports_cellgrid = True
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

    def compute_cellgrid_charged(self, s, neigh, cfg, special_lj,
                                 special_coul, eflag: bool, vflag: bool,
                                 rows=None):
        """(f, evdwl, ecoul, virial) of the grid-ordered state s over the
        pair list of its grid state neigh; energies None unless eflag,
        virial unless vflag.  rows, on a rank's local grid, the owned
        atoms' slots, whose rows alone are swept (B5-rows), as
        ``pair_lj_cut`` passes them to B1."""
        if s.special_tags is None:
            raise NotImplementedError(
                "lj/charmm/coul/long without bonds (no special lists) is "
                "not ported")
        c = self.kernel_coeffs(s.x, special_lj, special_coul)
        return charmm_cellgrid(s.x, s.q, s.type, neigh.pairs, neigh.npairs,
                               s.box, cfg, c, eflag, vflag, rows=rows)

    def pair_fn_ex(self, r2, itype, jtype, w_lj, w_coul, qi, qj):
        """(fpair, evdwl, ecoul, fcoul) per pair: the plain pair
        function (tpumd/models/pair_charmm.py::pair_fn_ex)."""
        c = self.kernel_coeffs(r2, (1.0,) * 4, (1.0,) * 4)
        return charmm_pair_fn(c)(r2, itype, jtype, w_lj, w_coul, qi, qj)


@register_pair("lj/charmm/coul/charmm")
class PairLJCharmmCoulCharmm(PairLJCharmmCoulLong):
    """CHARMM-switched LJ and switched Coulomb, no kspace
    (tpumd/models/pair_charmm.py:185-238), on the matrix engine only."""

    name = "lj/charmm/coul/charmm"
    supports_cellgrid = False
    charged = False

    def settings(self, cut_lj_inner, cut_lj, cut_coul_inner=None,
                 cut_coul=None):
        super().settings(cut_lj_inner, cut_lj, cut_coul)
        self.cut_coul_inner = (float(cut_coul_inner)
                               if cut_coul_inner is not None
                               else float(cut_lj_inner))
        if cut_coul is None:
            self.cut_coul = self.cut_lj

    def init(self):
        super().init()
        self.cut_coul_innersq = self.cut_coul_inner ** 2
        self.denom_coul = (self.cut_coulsq - self.cut_coul_innersq) ** 3
        self.drop_tables()

    def pair_fn_ex(self, r2, itype, jtype, w_lj, w_coul, qi, qj):
        lj1, lj2, lj3, lj4 = self.pair_coeffs(r2, itype, jtype, "lj1",
                                              "lj2", "lj3", "lj4")
        r2inv = 1.0 / r2
        in_coul = r2 < self.cut_coulsq
        forcecoul = self.units.qqr2e * qi * qj * torch.sqrt(r2inv)
        tt = self.cut_coulsq - r2
        sw = (tt * tt * (self.cut_coulsq + 2.0 * r2
                         - 3.0 * self.cut_coul_innersq) / self.denom_coul)
        # energy-switched, as the reference has it
        forcecoul = torch.where(r2 > self.cut_coul_innersq, forcecoul * sw,
                                forcecoul)
        forcecoul = torch.where(in_coul, forcecoul * w_coul, 0.0)
        ecoul = forcecoul

        in_lj = r2 < self.cut_ljsq
        r6inv = r2inv * r2inv * r2inv
        forcelj = r6inv * (lj1 * r6inv - lj2)
        philj = r6inv * (lj3 * r6inv - lj4)
        sw_on = r2 > self.cut_lj_innersq
        tt = self.cut_ljsq - r2
        switch1 = (tt * tt * (self.cut_ljsq + 2.0 * r2
                              - 3.0 * self.cut_lj_innersq) / self.denom_lj)
        switch2 = 12.0 * r2 * tt * (r2 - self.cut_lj_innersq) / self.denom_lj
        forcelj = torch.where(sw_on, forcelj * switch1 + philj * switch2,
                              forcelj)
        philj = torch.where(sw_on, philj * switch1, philj)
        forcelj = torch.where(in_lj, forcelj * w_lj, 0.0)
        evdwl = torch.where(in_lj, philj * w_lj, 0.0)
        return forcelj * r2inv, evdwl, ecoul, forcecoul * r2inv
