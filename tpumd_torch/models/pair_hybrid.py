"""pair_style hybrid, hybrid/overlay and hybrid/scaled (src/pair_hybrid.cpp,
src/pair_hybrid_overlay.cpp, src/pair_hybrid_scaled.cpp).

PyTorch counterpart of tpumd/models/pair_hybrid.py for the pairwise
sub-styles: each type pair belongs to one sub-style (hybrid) or to several
(overlay, scaled); pair_coeff routes by sub-style name.  Every sub-style
sweeps the same neighbor rows with its pair function masked by a
per-type-pair activation table on the device, and their forces, energies,
virials and per-atom tallies add, each times its constant factor under
hybrid/scaled (tpumd takes constants only).  For kspace, the Coulomb
cutoff and g_ewald are the coul/long sub-style's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.pairwise import pair_sums


class _Sub:
    """A sub-style and the type pairs it acts on."""

    def __init__(self, style, ntypes):
        self.style = style
        self.active = np.zeros((ntypes + 1, ntypes + 1), dtype=bool)
        self._dev = {}

    def mask(self, it, jt, like):
        key = like.device
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.active, device=like.device)
        return self._dev[key][it.long(), jt.long()]

    def pair_fns(self):
        """(pair_fn, pair_fn_ex) of the sub-style, masked to its pairs."""
        ex = getattr(self.style, "pair_fn_ex", None)
        if ex is not None:
            def fn_ex(r2, it, jt, w_lj, w_c, qi, qj):
                m = self.mask(it, jt, r2)
                return tuple(None if v is None else torch.where(m, v, 0.0)
                             for v in ex(r2, it, jt, w_lj, w_c, qi, qj))
            return None, fn_ex

        def fn(r2, it, jt):
            m = self.mask(it, jt, r2)
            return tuple(torch.where(m, v, 0.0)
                         for v in self.style.pair_fn(r2, it, jt))
        return fn, None


@register_pair("hybrid")
class PairHybrid(PairStyle):
    name = "hybrid"
    overlay = False

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        self.subs: list[_Sub] = []
        self.names: list[str] = []
        self.scales: list[float] = []

    def _make_subs(self, args):
        from tpumd_torch.models.registry import _PAIR_STYLES, \
            create_pair_style
        groups = []
        for tok in args:
            if isinstance(tok, str) and tok in _PAIR_STYLES:
                groups.append([tok])
            elif groups:
                groups[-1].append(tok)
            else:
                raise ValueError(f"pair_style {self.name}: {tok!r} is not a "
                                 "ported pair style")
        for g in groups:
            if g[0].startswith("hybrid"):
                raise ValueError(f"pair_style {self.name} inside a hybrid")
            style = create_pair_style(g[0], self.ntypes, g[1:],
                                      units=getattr(self, "units", None))
            if not style.matrix_engine or getattr(style, "is_granular",
                                                   False):
                raise NotImplementedError(
                    f"pair_style {self.name} with sub-style {g[0]}: only "
                    "pairwise sub-styles are ported")
            self.subs.append(_Sub(style, self.ntypes))
            self.names.append(g[0])
        self.scales = [1.0] * len(self.subs)

    def settings(self, *args):
        self._make_subs(args)

    def coeff(self, ilo, ihi, jlo, jhi, name, *args):
        name = str(name)
        if name == "none":
            for m in self.subs:
                m.active[ilo:ihi + 1, jlo:jhi + 1] = False
                m.active[jlo:jhi + 1, ilo:ihi + 1] = False
            return
        targets = [m for m, n in zip(self.subs, self.names) if n == name]
        if not targets:
            raise ValueError(f"pair_coeff: hybrid sub-style {name!r} not "
                             "found")
        if not self.overlay:
            # plain hybrid: the pair belongs to this sub-style only
            for m in self.subs:
                if m not in targets:
                    m.active[ilo:ihi + 1, jlo:jhi + 1] = False
                    m.active[jlo:jhi + 1, ilo:ihi + 1] = False
        for m in targets:
            m.style.coeff(ilo, ihi, jlo, jhi, *args)
            m.active[ilo:ihi + 1, jlo:jhi + 1] = True
            m.active[jlo:jhi + 1, ilo:ihi + 1] = True
            m._dev = {}
        self._setflag[ilo:ihi + 1, jlo:jhi + 1] = True

    def init(self):
        for m in self.subs:
            m.style.allow_unset = True
            m.style.shift = self.shift or m.style.shift
            m.style.init()

    @property
    def max_cutoff(self) -> float:
        return max(m.style.max_cutoff for m in self.subs)

    def _long(self):
        longs = [m.style for m in self.subs if hasattr(m.style, "g_ewald")]
        return longs[0] if longs else None

    @property
    def cut_coul(self):
        """The coul/long sub-style's Coulomb cutoff, for kspace."""
        style = self._long()
        if style is None:
            raise AttributeError("cut_coul: no coul/long sub-style")
        return style.cut_coul

    @property
    def g_ewald(self):
        style = self._long()
        if style is None:
            raise AttributeError("g_ewald: no coul/long sub-style")
        return style.g_ewald

    @g_ewald.setter
    def g_ewald(self, value):
        for m in self.subs:
            if hasattr(m.style, "g_ewald"):
                m.style.g_ewald = value

    def ecoul_self_atom(self, q):
        """Each atom's Coulomb self-energy summed over the sub-styles that
        have one: the reference tallies it per sub-style over all atoms,
        whatever the type-pair activation (src/pair_hybrid.cpp)."""
        e = torch.zeros_like(q)
        for scale, m in zip(self.scales, self.subs):
            if hasattr(m.style, "ecoul_self_atom"):
                e = e + scale * m.style.ecoul_self_atom(q)
        return e

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag, vflag, q=None, ext=None):
        """The sum over the sub-styles of pair_sums' outputs, each times
        its factor; with eflag = vflag = "atom" the per-atom tallies."""
        out = None
        for scale, m in zip(self.scales, self.subs):
            fn, fn_ex = m.pair_fns()
            r = pair_sums(x, type_, box, idx, sbits, fn, special_lj,
                          special_coul, eflag, vflag, q=q, pair_fn_ex=fn_ex,
                          ext=ext)
            r = [None if v is None else (v if scale == 1.0 else scale * v)
                 for v in r]
            out = r if out is None else [
                a if b is None else b if a is None else a + b
                for a, b in zip(out, r)]
        return tuple(out)


@register_pair("hybrid/overlay")
class PairHybridOverlay(PairHybrid):
    name = "hybrid/overlay"
    overlay = True


@register_pair("hybrid/scaled")
class PairHybridScaled(PairHybrid):
    """hybrid/overlay with a constant factor before each sub-style, which
    multiplies its forces, energies and virial."""

    name = "hybrid/scaled"
    overlay = True

    def settings(self, *args):
        from tpumd_torch.models.registry import _PAIR_STYLES
        toks, scales, rest = list(args), [], []
        for i, tok in enumerate(toks):
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            if isinstance(nxt, str) and nxt in _PAIR_STYLES \
                    and not (isinstance(tok, str) and tok in _PAIR_STYLES):
                if isinstance(tok, str):
                    raise NotImplementedError(
                        f"pair_style hybrid/scaled factor {tok!r}: only "
                        "constant factors are ported (as in tpumd)")
                scales.append(float(tok))
            else:
                rest.append(tok)
        self._make_subs(rest)
        if len(scales) != len(self.subs):
            raise ValueError("hybrid/scaled: one factor per sub-style")
        self.scales = scales
