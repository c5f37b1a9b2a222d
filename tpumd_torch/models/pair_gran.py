"""Granular Hookean contact with shear history (pair gran/hooke/history).

Settings per the reference (PairGranHookeHistory::settings,
src/GRANULAR/pair_gran_hooke_history.cpp), as tpumd/models/pair_gran.py
has them: kn, kt (NULL: 2/7 kn), gamman, gammat (NULL: gamman / 2),
xmu, dampflag (0 zeroes gammat) and the optional ``limit_damping``.  The
neighbor cutoff is the largest contact distance, twice the largest
radius.  Fix freeze hands its group bit to the style (the effective-mass
rule, PairGranHookeHistory::init_style), and the set-up hands it the
``neigh_modify exclude group`` bit pairs.  Forces and torques go through
the cell-grid kernel ``ops/gran_cellgrid.py`` (its plain version on the
CPU), which also advances the per-contact history.  The style adds no
energy and no virial, as in tpumd.

gran/hertz/history and gran/hooke are not ported: they raise.
"""

from __future__ import annotations

import torch

from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.cellgrid_gran import GranCoeffs
from tpumd_torch.ops.gran_cellgrid import gran_cellgrid


@register_pair("gran/hooke/history")
class PairGranHookeHistory(PairStyle):
    name = "gran/hooke/history"
    is_granular = True

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        self.freeze_group_bit = 0   # set by fix freeze at set-up
        self.exclude_bits = ()      # ((b1, b2), ...), set at set-up
        self._max_radius = 0.5

    def settings(self, kn, kt, gamman, gammat, xmu, dampflag, *extra):
        self.kn = float(kn)
        self.kt = self.kn * 2.0 / 7.0 if kt == "NULL" else float(kt)
        self.gamman = float(gamman)
        self.gammat = (0.5 * self.gamman if gammat == "NULL"
                       else float(gammat))
        self.xmu = float(xmu)
        self.dampflag = int(dampflag)
        if self.dampflag == 0:
            self.gammat = 0.0
        if extra and list(extra) != ["limit_damping"]:
            raise NotImplementedError(
                f"pair_style {self.name} keywords {list(extra)}: only "
                "limit_damping is ported")
        self.limit_damping = bool(extra)

    def coeff(self, ilo, ihi, jlo, jhi, *rest):
        # pair_coeff * * (the style takes no per-type coefficients)
        if rest:
            raise NotImplementedError(
                f"pair_coeff arguments {list(rest)} for {self.name}")

    def init(self):
        pass

    def set_max_radius(self, r: float):
        self._max_radius = float(r)

    @property
    def max_cutoff(self) -> float:
        # the largest contact distance (PairGranHookeHistory::init_one)
        return 2.0 * self._max_radius

    def kernel_coeffs(self) -> GranCoeffs:
        return GranCoeffs(self.kn, self.kt, self.gamman, self.gammat,
                          self.xmu, self.limit_damping,
                          int(self.freeze_group_bit), tuple(self.exclude_bits))

    def compute_gran_cellgrid(self, s, valid, shear_tags, shear, cfg, dt,
                              shearupdate: bool):
        """(f, torque, shear_tags, shear) of one sweep on the grid."""
        planes = (s.v, s.omega, s.radius,
                  torch.where(s.rmass > 0, s.rmass, 1.0), s.gmask)
        return gran_cellgrid(s.x, s.tag, valid, shear_tags, shear, s.box,
                             cfg, self.kernel_coeffs(),
                             planes, dt, shearupdate)


def _unported(name, why):
    class Unported(PairStyle):
        def __init__(self, ntypes):
            raise NotImplementedError(f"pair_style {name} is not ported: "
                                      f"{why}")
    register_pair(name)(Unported)


_unported("gran/hertz/history", "it would be a Hertzian flag of the "
          "gran/hooke/history kernel (B6), still to come")
_unported("gran/hooke", "it runs on tpumd's matrix engine, not yet ported")
