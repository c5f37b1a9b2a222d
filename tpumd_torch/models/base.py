"""Pair-style base class: per-type coefficient tables and mixing rules.

A pair style is a host-side config object holding (ntypes+1, ntypes+1)
numpy tables, 1-based (tpumd/models/base.py, src/pair.cpp).
"""

from __future__ import annotations

import numpy as np
import torch


class PairStyle:
    name = "none"
    tail_flag = False   # pair_modify tail yes (styles with tail terms)

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

    @staticmethod
    def coef(arr, itype, jtype, like: torch.Tensor):
        """Per-pair coefficient: a plain read of the (ntypes+1)^2 table."""
        tbl = torch.as_tensor(arr, dtype=like.dtype, device=like.device)
        return tbl[itype.long(), jtype.long()]
