"""Pair-style base class: per-type coefficient tables and mixing rules.

A pair style is a host-side config object holding (ntypes+1, ntypes+1)
numpy tables, 1-based (tpumd/models/base.py, src/pair.cpp).  A pairwise
style gives ``pair_fn`` and so runs on the matrix neighbor engine through
``compute`` (``ops/pairwise.py::pair_sums``); the cell grid calls the
style's own ``compute_cellgrid``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.ops.pairwise import pair_sums


class PairStyle:
    name = "none"
    tail_flag = False   # pair_modify tail yes (styles with tail terms)
    # the cell grid's kernels take this style (Simulation._resolve_mode)
    supports_cellgrid = True
    # the matrix engine evaluates this style (compute, or compute_gran)
    matrix_engine = True
    # pairwise styles take the matrix engine's multi-image mode as they are
    supports_image_ext = True
    # the style gives per-atom energy and virial tallies (compute pe/atom,
    # stress/atom): pair_sums on the matrix engine, the kernels' per-slot
    # outputs on the grid
    peratom = True

    def __init__(self, ntypes: int):
        self.ntypes = ntypes
        self.shift = False      # pair_modify shift
        self.mix = "geometric"
        self._setflag = np.zeros((ntypes + 1, ntypes + 1), dtype=bool)

    def settings(self, *args):
        raise NotImplementedError

    def coeff(self, *args):
        raise NotImplementedError

    def init(self):
        """Fill unset i-j coeffs by mixing; compute derived tables."""
        raise NotImplementedError

    @property
    def max_cutoff(self) -> float:
        raise NotImplementedError

    def mix_energy(self, e1, e2, s1, s2) -> float:
        # Pair::mix_energy (src/pair.cpp:705-723)
        if self.mix == "sixthpower":
            return (2.0 * np.sqrt(e1 * e2) * s1**3 * s2**3) / (s1**6 + s2**6)
        return np.sqrt(e1 * e2)

    def mix_distance(self, s1, s2) -> float:
        if self.mix == "geometric":
            return np.sqrt(s1 * s2)
        if self.mix == "sixthpower":
            return (0.5 * (s1**6 + s2**6)) ** (1.0 / 6.0)
        return 0.5 * (s1 + s2)  # arithmetic

    def pair_fn(self, r2, itype, jtype):
        raise NotImplementedError

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag: bool, vflag: bool, q=None, ext=None):
        """(f, evdwl, ecoul, virial) on the matrix neighbor engine
        (tpumd/models/base.py:64-84)."""
        return pair_sums(x, type_, box, idx, sbits, self.pair_fn,
                         special_lj, special_coul, eflag, vflag, q=q,
                         pair_fn_ex=getattr(self, "pair_fn_ex", None),
                         ext=ext)
