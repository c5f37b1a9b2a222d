"""lj/cut pair style: 12-6 Lennard-Jones with cutoff.

Physics per the reference kernel (src/pair_lj_cut.cpp:69-140, init_one
mixing at :580-610): forcelj = r^-6 (lj1 r^-6 - lj2), fpair = forcelj/r^2,
energy = r^-6 (lj3 r^-6 - lj4) - offset.  PyTorch counterpart of
tpumd/models/pair_lj_cut.py.  The cell grid's kernels take one atom type;
the matrix engine (``pair_fn``) any number, its coefficients read as one
row gather of a (ntypes+1)^2 by 6 table.  On the grid the style sweeps
the grid's pair list, built at every re-bin (with FENE
bonds riding the kernel, the bond partners coded 1).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows
from tpumd_torch.ops.lj_cellgrid import LJCoeffs, lj_cellgrid
from tpumd_torch.ops.lj_fene_cellgrid import lj_fene_cellgrid


@register_pair("lj/cut")
class PairLJCut(PairStyle):
    tail_flag = False  # pair_modify tail yes
    etail = 0.0
    ptail = 0.0

    name = "lj/cut"

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        shape = (ntypes + 1, ntypes + 1)
        self.epsilon = np.zeros(shape)
        self.sigma = np.zeros(shape)
        self.cut = np.zeros(shape)
        self.cut_global = 0.0
        self._coef_tables = {}

    @property
    def supports_cellgrid(self) -> bool:
        return self.ntypes == 1

    def settings(self, cut_global):
        self.cut_global = float(cut_global)

    def coeff(self, ilo, ihi, jlo, jhi, epsilon, sigma, cut=None):
        cut = self.cut_global if cut is None else float(cut)
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.epsilon[i, j] = epsilon
                self.sigma[i, j] = sigma
                self.cut[i, j] = cut
                self._setflag[i, j] = True

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
                    self.cut[i, j] = self.mix_distance(
                        self.cut[i, i], self.cut[j, j])
                for arr in (self.epsilon, self.sigma, self.cut):
                    arr[j, i] = arr[i, j]

        eps, sig, cut = self.epsilon, self.sigma, self.cut
        with np.errstate(divide="ignore", invalid="ignore"):
            sr6 = np.where(cut > 0, (sig / np.where(cut > 0, cut, 1)) ** 6, 0.0)
        self.lj1 = 48.0 * eps * sig**12
        self.lj2 = 24.0 * eps * sig**6
        self.lj3 = 4.0 * eps * sig**12
        self.lj4 = 4.0 * eps * sig**6
        if self.shift:
            self.offset = np.where(cut > 0, 4.0 * eps * (sr6 * sr6 - sr6), 0.0)
        else:
            self.offset = np.zeros_like(eps)
        self.cutsq = cut * cut
        self._coef_tables = {}

    @property
    def max_cutoff(self) -> float:
        return float(self.cut[1:, 1:].max())

    def compute_tails(self, type_counts):
        """Analytic LJ tail corrections (PairLJCut::init_one tail block):
        etail_ij = 8 pi Ni Nj eps sig^6 (sig^6 - 3 rc^6) / (9 rc^9);
        i != j pairs count twice (Pair::init, src/pair.cpp:278-284)."""
        self.etail = self.ptail = 0.0
        if not self.tail_flag:
            return
        for i in range(1, self.ntypes + 1):
            for j in range(i, self.ntypes + 1):
                sig6 = self.sigma[i, j] ** 6
                rc3 = self.cut[i, j] ** 3
                rc6 = rc3 * rc3
                rc9 = rc3 * rc6
                pref = (8.0 * np.pi * type_counts[i] * type_counts[j]
                        * self.epsilon[i, j] * sig6 / (9.0 * rc9))
                e_ij = pref * (sig6 - 3.0 * rc6)
                p_ij = 2.0 * pref * (2.0 * sig6 - 3.0 * rc6)
                mult = 2.0 if i != j else 1.0
                self.etail += mult * e_ij
                self.ptail += mult * p_ij

    def kernel_coeffs(self) -> LJCoeffs:
        """Scalar coefficients of the single-type force kernel."""
        return LJCoeffs(*(float(a[1, 1]) for a in (
            self.lj1, self.lj2, self.lj3, self.lj4, self.offset, self.cutsq)))

    def compute_cellgrid(self, x, valid, box, cfg, eflag: bool, vflag: bool,
                         bond=None, plist=None):
        """(f, evdwl, virial, ebond) on the cell grid; evdwl and ebond are
        None unless eflag, virial unless vflag, ebond without bonds.
        Every eflag/vflag combination goes through a list kernel (its
        plain version for CPU tensors): the LJ kernel over the grid's pair
        list plist = (pairs, npairs, rows), or with bond = (bond style,
        (pairs, npairs, bond_slots, rows)) the LJ+FENE kernel."""
        if self.ntypes != 1:
            raise NotImplementedError(
                "lj/cut with more than one atom type: the cell-grid kernels "
                "are single-type")
        if bond is None:
            return lj_cellgrid(x, valid, box, cfg, self.kernel_coeffs(),
                               eflag, vflag, plist) + (None,)
        style, plist = bond
        if style.name != "fene":
            raise NotImplementedError(
                f"bond_style {style.name} in the pair kernel: only fene is "
                "ported")
        nb = plist[2].shape[1]
        if nb > 2:
            raise NotImplementedError(
                f"{nb} bond partners per atom: the LJ+FENE kernel holds at "
                "most 2 (Simulation._grid_refusal sends such a deck to the "
                "matrix engine, where FENE runs per tuple)")
        return lj_fene_cellgrid(x, valid, box, cfg, self.kernel_coeffs(),
                                style.kernel_coeffs(), eflag, vflag, plist)

    def _coef_table(self, like: torch.Tensor) -> torch.Tensor:
        """((ntypes+1)^2, 6) rows lj1 lj2 lj3 lj4 offset cutsq by type
        pair i (ntypes+1) + j, on like's device and dtype (made once)."""
        key = (like.dtype, like.device)
        tbl = self._coef_tables.get(key)
        if tbl is None:
            tbl = torch.as_tensor(np.stack(
                [a.reshape(-1) for a in (self.lj1, self.lj2, self.lj3,
                                         self.lj4, self.offset,
                                         self.cutsq)], axis=1),
                dtype=like.dtype, device=like.device)
            self._coef_tables[key] = tbl
        return tbl

    def pair_fn(self, r2, itype, jtype):
        """(fpair, evdwl) per pair on broadcastable 2-D r2, itype and
        jtype, the coefficients one row gather of the type-pair table
        (tpumd/models/pair_lj_cut.py::pair_fn)."""
        pair = (itype * (self.ntypes + 1) + jtype).to(torch.int32)
        pair = pair.expand(r2.shape).contiguous()
        lj1, lj2, lj3, lj4, off, cutsq = torch.unbind(
            gather_rows(self._coef_table(r2), pair), dim=-1)
        inside = r2 < cutsq
        r2inv = torch.where(inside, 1.0 / r2, 0.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = r6inv * (lj1 * r6inv - lj2) * r2inv
        evdwl = torch.where(inside, r6inv * (lj3 * r6inv - lj4) - off, 0.0)
        return fpair, evdwl
