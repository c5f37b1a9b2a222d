"""Bond styles: FENE, evaluated inside the pair kernel.

PyTorch counterpart of BondStyle and BondFENE in tpumd/models/bonded.py
(src/MOLECULE/bond_fene.cpp:53-120).  The port evaluates 2-body bonds
only inside the cell-grid pair kernel, by matching each candidate's tag
against the i slot's bond-partner tags, so a style here is a host-side
coefficient table plus the per-pair force and energy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.registry import register_bonded
from tpumd_torch.ops.lj_fene_cellgrid import FENECoeffs, fene_wca


class BondStyle:
    name = "none"

    def __init__(self, ntypes: int):
        self.ntypes = ntypes

    def coeff(self, *args):
        raise NotImplementedError

    def bond_fn(self, r2, btype):
        """(fbond, ebond) per bond: f_on_atom1 = fbond * (x1 - x2)."""
        raise NotImplementedError


@register_bonded("bond", "fene")
class BondFENE(BondStyle):
    """FENE + shifted-LJ repulsion:
    E = -0.5 K R0^2 ln(1-(r/R0)^2) + [4 eps((s/r)^12-(s/r)^6) + eps],
    the LJ part active below 2^(1/6) sigma.  The reference clamps
    1-(r/R0)^2 at 0.1 after a "FENE bond too long" warning; so do both
    packages."""

    name = "fene"

    def __init__(self, ntypes):
        super().__init__(ntypes)
        self.k = np.zeros(ntypes + 1)
        self.r0 = np.zeros(ntypes + 1)
        self.epsilon = np.zeros(ntypes + 1)
        self.sigma = np.zeros(ntypes + 1)

    def coeff(self, btype, k, r0, epsilon, sigma):
        self.k[btype] = k
        self.r0[btype] = r0
        self.epsilon[btype] = epsilon
        self.sigma[btype] = sigma

    def bond_fn(self, r2, btype):
        """Coefficients read from the per-type tables."""
        def tbl(a):
            return torch.as_tensor(a, dtype=r2.dtype,
                                   device=r2.device)[btype.long()]
        sig = tbl(self.sigma)
        r0 = tbl(self.r0)
        return fene_wca(r2, tbl(self.k), r0 * r0, tbl(self.epsilon),
                        sig * sig)

    @property
    def kernel_reach(self) -> float:
        """FENE bonds cannot stretch past R0 (the log diverges): when the
        largest R0 is within cutneigh, every partner is inside the
        27-cell stencil and the bond can ride the grid kernel."""
        return float(np.max(self.r0[1:])) if len(self.r0) > 1 else 0.0

    def kernel_bond_fn(self, r2, btype):
        """bond_fn with coefficients selected per type (the form of
        tpumd's BondFENE.kernel_bond_fn)."""
        def sel(table):
            if self.ntypes == 1:
                return float(table[1])
            out = torch.zeros((), dtype=r2.dtype, device=r2.device)
            for t in range(1, self.ntypes + 1):
                out = out + (btype == t).to(r2.dtype) * float(table[t])
            return out
        k, r0 = sel(self.k), sel(self.r0)
        eps, sig = sel(self.epsilon), sel(self.sigma)
        return fene_wca(r2, k, r0 * r0, eps, sig * sig)

    def kernel_coeffs(self) -> FENECoeffs:
        """Scalar coefficients of the single-bond-type kernel."""
        if self.ntypes != 1:
            raise NotImplementedError(
                "bond_style fene with more than one bond type: the "
                "LJ+FENE cell-grid kernel takes one")
        return FENECoeffs(float(self.k[1]), float(self.r0[1]) ** 2,
                          float(self.epsilon[1]), float(self.sigma[1]) ** 2)
