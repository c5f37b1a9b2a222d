"""Pair-style base class: per-type coefficient tables and mixing rules.

A pair style is a host-side config object holding (ntypes+1, ntypes+1)
numpy tables, 1-based (tpumd/models/base.py, src/pair.cpp).  A pairwise
style gives ``pair_fn`` and so runs on the matrix neighbor engine through
``compute`` (``ops/pairwise.py::pair_sums``); the cell grid calls the
style's own ``compute_cellgrid``, which only the styles with a grid kernel
have (``supports_cellgrid``).  ``pair_coeffs`` reads a style's per-type-pair
tables at each pair as one row gather of a packed device table, where
tpumd's ``coef()`` resolves them with select chains for the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.ops.gather import gather_rows
from tpumd_torch.ops.pairwise import pair_sums


class PairStyle:
    name = "none"
    tail_flag = False   # pair_modify tail yes (styles with tail terms)
    # the cell grid's kernels take this style (Simulation._resolve_mode):
    # only the styles with a grid kernel set it
    supports_cellgrid = False
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

    def pair_coeffs(self, r2, itype, jtype, *names):
        """The (ntypes+1, ntypes+1) tables named by ``names`` (attributes of
        the style) at each pair of broadcastable itype and jtype, shaped
        like r2, in r2's dtype: one row gather (P1) of the tables packed
        as ((ntypes+1)^2, len(names)) on r2's device, made once per
        set-up (``init`` drops them)."""
        key = (names, r2.dtype, r2.device)
        cache = self.__dict__.setdefault("_packed", {})
        tbl = cache.get(key)
        if tbl is None:
            tbl = cache[key] = torch.as_tensor(np.stack(
                [np.broadcast_to(np.asarray(self.coeff_table(n), np.float64),
                                 self._setflag.shape).reshape(-1)
                 for n in names], axis=1), dtype=r2.dtype, device=r2.device)
        pair = (itype * (self.ntypes + 1) + jtype).to(torch.int32)
        pair = pair.expand(r2.shape).contiguous()
        return torch.unbind(gather_rows(tbl, pair), dim=-1)

    def coeff_table(self, name):
        """The (ntypes+1, ntypes+1) table that pair_coeffs reads by name."""
        return getattr(self, name)

    def drop_tables(self):
        """Forget the device tables (the host tables changed)."""
        self.__dict__.pop("_packed", None)

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag: bool, vflag: bool, q=None, ext=None):
        """(f, evdwl, ecoul, virial) on the matrix neighbor engine
        (tpumd/models/base.py:64-84)."""
        return pair_sums(x, type_, box, idx, sbits, self.pair_fn,
                         special_lj, special_coul, eflag, vflag, q=q,
                         pair_fn_ex=getattr(self, "pair_fn_ex", None),
                         ext=ext)


class SimpleTablePair(PairStyle):
    """Per-type-pair coefficients ``params`` (ncoeff, ntypes+1, ntypes+1)
    with a global cutoff (tpumd/models/pair_misc.py::_SimpleTablePair):
    unset i-j pairs mix from i-i and j-j, the first coefficient by
    ``mix_energy``, the others arithmetically, the cutoff the global one;
    ``derive`` makes each style's own tables from them."""

    ncoeff = 0
    # hybrid sub-styles own only some type pairs
    allow_unset = False

    def __init__(self, ntypes):
        super().__init__(ntypes)
        shape = (ntypes + 1, ntypes + 1)
        self.params = np.zeros((self.ncoeff,) + shape)
        self.cut = np.zeros(shape)
        self.cut_global = 0.0

    def settings(self, cut_global):
        self.cut_global = float(cut_global)

    def coeff(self, ilo, ihi, jlo, jhi, *vals):
        cut = self.cut_global
        if len(vals) == self.ncoeff + 1:
            *vals, cut = vals
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                for c, v in enumerate(vals):
                    self.params[c, i, j] = v
                self.cut[i, j] = cut
                self._setflag[i, j] = True

    def init(self):
        nt = self.ntypes
        for i in range(1, nt + 1):
            for j in range(i, nt + 1):
                if not self._setflag[i, j]:
                    if self._setflag[i, i] and self._setflag[j, j]:
                        for c in range(self.ncoeff):
                            self.params[c, i, j] = self.mix_energy(
                                self.params[c, i, i], self.params[c, j, j],
                                1.0, 1.0) if c == 0 else 0.5 * (
                                self.params[c, i, i] + self.params[c, j, j])
                        self.cut[i, j] = self.cut_global
                    elif not self.allow_unset:
                        raise ValueError(f"pair coeffs not set for {i},{j}")
                self.params[:, j, i] = self.params[:, i, j]
                self.cut[j, i] = self.cut[i, j]
        self.cutsq = self.cut * self.cut
        self.derive()
        self.drop_tables()

    def derive(self):
        pass

    @property
    def max_cutoff(self):
        return float(self.cut[1:, 1:].max())

    def coeff_table(self, name):
        # "p0", "p1", ...: the coefficients by their index in params
        if name[:1] == "p" and name[1:].isdigit():
            return self.params[int(name[1:])]
        return getattr(self, name)
