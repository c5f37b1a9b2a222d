"""TIP4P water: pair_style lj/cut/tip4p/long and its charge sites.

PyTorch counterpart of tpumd/models/pair_tip4p.py (the reference's
src/KSPACE/pair_lj_cut_tip4p_long.cpp).  The oxygen's charge sits on a
massless M site on the H-O-H bisector, xM = xO + alpha/2 ((xH1 - xO) + (xH2
- xO)) with the closest images of the H, alpha = qdist / (cos(theta0/2) b0)
from the bond and angle styles' equilibrium geometry (init_style
:458-486).  The site is an affine map of the atoms, so the Coulomb part is
the coul/long sum on the sites' positions (the same neighbour rows as the
LJ part, which runs on the atoms), and a site force goes back onto the
atoms by the chain rule fO = (1 - alpha) fM, fH = alpha/2 fM (Feenstra
1999; :287-323), with pppm/tip4p's forces on the sites added first.  The
virial is the site virial of the two sums, as in tpumd (the reference
tallies ev_tally_tip4p: ROADMAP C28).

Each O's two H are found by tag from the bond topology once per set-up,
and every evaluation resolves the three rows of each water from the tags
(one P1 gather of the rows of the tags, one of their positions), so no
re-order of the rows can pair an O with another water's H.  The neighbour
cutoff is cut_coul + 2 qdist where that is the larger, so that every site
pair within cut_coul is on the list.  The matrix engine only, in a box
at least 2 cutneigh wide (tpumd asserts against image copies).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.models.pair_misc import PairLJCutCoulLong, \
    coul_long_terms, lj_terms
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.cellgrid import row2slot_from_tags
from tpumd_torch.ops.gather import gather_rows
from tpumd_torch.ops.pairwise import pair_sums_blocked


@dataclasses.dataclass(frozen=True)
class ChargeSites:
    """The charge sites of one force evaluation: xq, the rows' positions
    with each O's row at its M site, and the rows of each water's O, H1
    and H2, (M, 3) int32."""

    xq: torch.Tensor
    rows: torch.Tensor
    alpha: float

    def distribute(self, fq):
        """Atom forces of the site forces fq (N, 3): each O keeps 1 -
        alpha of its site's force, each of its H gains alpha/2."""
        ro, rh1, rh2 = (r.long() for r in self.rows.unbind(1))
        fo = gather_rows(fq.contiguous(), self.rows[:, 0].contiguous())
        f = fq.index_copy(0, ro, (1.0 - self.alpha) * fo)
        f.index_add_(0, rh1, (0.5 * self.alpha) * fo)
        f.index_add_(0, rh2, (0.5 * self.alpha) * fo)
        return f


@register_pair("lj/cut/tip4p/long")
class PairLJCutTIP4PLong(PairLJCutCoulLong):
    name = "lj/cut/tip4p/long"
    supports_image_ext = False
    peratom = False
    is_tip4p = True

    def settings(self, otype, htype, btype, atype, qdist, cut_lj,
                 cut_coul=None):
        self.typeO, self.typeH = int(otype), int(htype)
        self.typeB, self.typeA = int(btype), int(atype)
        self.qdist = float(qdist)
        super().settings(cut_lj, cut_coul)
        self.alpha = 0.0
        self.waters = None     # (M, 3) tag - 1 of each O, H1, H2

    @property
    def max_cutoff(self):
        # the list reaches every site pair: cut_coul + 2 qdist
        # (cut_coulsqplus, :123)
        return max(float(self.cut[1:, 1:].max()),
                   self.cut_coul + 2.0 * self.qdist)

    def setup_tip4p(self, bonded: dict, bonds, types_by_tag, device):
        """alpha from the bond and angle styles' equilibrium geometry, and
        each O's two H by tag from the bonds of type typeB (tpumd/models/
        pair_tip4p.py:54-93, which keeps rows instead).  bonds: (M, 3)
        type, tag, tag; types_by_tag: (natoms + 1,) the type of each
        tag."""
        bstyle, astyle = bonded.get("bond"), bonded.get("angle")
        b0 = getattr(bstyle, "r0", None)
        theta0 = getattr(astyle, "theta0", None)
        if b0 is None or theta0 is None:
            raise ValueError("pair_style lj/cut/tip4p/long needs bond and "
                             "angle styles with an equilibrium geometry "
                             "(r0, theta0)")
        self.alpha = self.qdist / (np.cos(0.5 * theta0[self.typeA])
                                   * b0[self.typeB])
        if bonds is None:
            raise ValueError("pair_style lj/cut/tip4p/long needs the bond "
                             "topology")
        typ = np.asarray(types_by_tag)
        partners = {}
        for bt, t1, t2 in np.asarray(bonds):
            if bt != self.typeB:
                continue
            for o, h in ((t1, t2), (t2, t1)):
                if typ[o] == self.typeO and typ[h] == self.typeH:
                    partners.setdefault(int(o), []).append(int(h))
        otags = np.flatnonzero(typ == self.typeO)
        if any(len(partners.get(int(o), ())) != 2 for o in otags):
            raise ValueError("TIP4P hydrogen is missing: an O without "
                             "exactly two bonded H")
        table = np.array([[o] + partners[int(o)] for o in otags],
                         np.int32).reshape(-1, 3) - 1
        self.waters = torch.as_tensor(table, device=device)

    def charge_sites(self, s, natoms: int) -> ChargeSites:
        """The sites of state s (compute_newsite :576-590)."""
        tag_rows = row2slot_from_tags(s.tag, natoms).to(torch.int32)
        rows = gather_rows(tag_rows.view(-1, 1), self.waters)[..., 0]
        xw = gather_rows(s.x, rows)                      # (M, 3, 3)
        d1 = minimum_image(xw[:, 1] - xw[:, 0], s.box)
        d2 = minimum_image(xw[:, 2] - xw[:, 0], s.box)
        xm = xw[:, 0] + (0.5 * self.alpha) * (d1 + d2)
        xq = s.x.index_copy(0, rows[:, 0].long(), xm)
        return ChargeSites(xq=xq, rows=rows.contiguous(), alpha=self.alpha)

    def _lj_fn(self, r2, it, jt):
        return lj_terms(self, r2, it, jt, 1.0)

    def _coul_fn_ex(self, r2, it, jt, w_lj, w_coul, qi, qj):
        ec, fcoul = coul_long_terms(self, r2, w_coul, qi, qj)
        z = torch.zeros_like(r2)
        return z, z, ec, fcoul

    def compute_sites(self, s, idx, sbits, sites: ChargeSites, special_lj,
                      special_coul, eflag: bool, vflag: bool):
        """(f on the atoms (LJ), fq on the sites (Coulomb), evdwl, ecoul,
        virial): the LJ sum on the atoms and the coul/long sum on the
        sites over the same neighbour rows (tpumd/models/pair_tip4p.py:
        137-153), each in row blocks (``pair_sums_blocked``)."""
        f, evdwl, _, vir = pair_sums_blocked(
            s.x, s.type, s.box, idx, sbits, self._lj_fn, special_lj, None,
            eflag, vflag)
        fq, _, ecoul, vir2 = pair_sums_blocked(
            sites.xq, s.type, s.box, idx, sbits, None, special_lj,
            special_coul, eflag, vflag, q=s.q, pair_fn_ex=self._coul_fn_ex)
        return f, fq, evdwl, ecoul, (vir + vir2) if vflag else None
