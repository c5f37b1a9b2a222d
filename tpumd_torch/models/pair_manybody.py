"""Many-body pair styles defined by their total energy: sw, tersoff,
tersoff/mod, tersoff/zbl, vashishta, atm and edip (src/MANYBODY/), the
port's copy of tpumd/models/pair_manybody.py, on full neighbor rows of the
matrix engine.

Each style states its energy as a function of the minimum-image
displacements ``d[i, k] = x_i - x_idx[i, k]`` (N, K, 3) of the padded
neighbor matrix (padding: the row's own index).  ``EnergyPairStyle``
gathers the neighbours' coordinates and types with one row gather (P1,
``ops/gather.py``) outside autograd, makes ``d`` the leaf, and takes
``g = dE/dd`` with ``torch.autograd.grad``:

* the force on atom i is ``-sum_k g[i, k]`` plus every ``g[j, k]`` whose
  neighbour ``idx[j, k]`` is i (``index_add_``);
* the virial is ``W_ab = -sum d_b g_a`` (xx yy zz xy xz yz), the strain
  derivative that tpumd takes with a second ``jax.grad``.

P1 writes its output outside autograd, so the gather itself carries no
gradient: the j side of every term reaches the forces through the scatter,
on the card as on the CPU.  The energy is a sum over central atoms, so the
rows are taken in blocks (``block_elems`` elements of the (rows, K, K)
tensors a block), each with its own forward and backward pass, which
bounds autograd's saved tensors at any N.

Per-type parameters are (ntypes+1,)*3 numpy tables; a table that holds one
value over the real types reads as a number (``_tp``), else it is indexed
at the atoms' types on the device.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows


def neighbor_rows(x, type_, box, idx):
    """(d (N, K, 3), jtype (N, K) int64): the minimum-image displacements
    x_i - x_j and the neighbours' types, from one P1 gather of the packed
    rows (x, y, z, type), outside autograd."""
    with torch.no_grad():
        pj = gather_rows(torch.cat([x, type_.to(x.dtype)[:, None]], dim=1),
                         idx)
        d = minimum_image(x[:, None, :] - pj[..., :3], box)
        jt = pj[..., 3].round().long()
    return d, jt


class EnergyPairStyle(PairStyle):
    """A pair style given by its total energy ``energy(d, it, jt, idx,
    rows)`` of a block of rows: d (B, K, 3), it (B, 1) and jt (B, K) int64
    types, idx (B, K) neighbour rows, rows (B, 1) the block's own row
    indices (idx == rows is padding)."""

    supports_cellgrid = False
    supports_image_ext = False
    peratom = False
    matrix_engine = True
    # elements of the (rows, K, K) tensors a block of rows holds
    block_elems = 1 << 25
    # per-row cost in units of K*K (atm's triangles hold 3-vectors)
    kk_weight = 1

    def energy(self, d, it, jt, idx, rows):
        raise NotImplementedError

    def _tp(self, name, *ix):
        """Table ``self.p[name]`` at type indices ix: a number where the
        table holds one value over the real types."""
        t = np.asarray(self.p[name])
        real = t[(slice(1, None),) * t.ndim]
        if real.size and np.all(real == real.flat[0]):
            return float(real.flat[0])
        dev = ix[0].device
        cache = self.__dict__.setdefault("_dev_tables", {})
        key = (name, dev, self._dtype)
        tab = cache.get(key)
        if tab is None:
            tab = cache[key] = torch.as_tensor(t, dtype=self._dtype,
                                               device=dev)
        return tab[ix]

    def drop_tables(self):
        super().drop_tables()
        self.__dict__.pop("_dev_tables", None)

    def rows_per_block(self, n, k):
        return max(1, min(n, self.block_elems // max(1, k * k
                                                     * self.kk_weight)))

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag: bool, vflag: bool, q=None, ext=None):
        """(f, evdwl, None, virial) on the matrix engine; evdwl is None
        unless eflag, the virial None unless vflag."""
        if ext is not None:
            raise NotImplementedError(
                f"pair_style {self.name}: a box narrower than 2*cutneigh "
                "(the multi-image mode) is not ported for many-body styles")
        d_all, jt_all = neighbor_rows(x, type_, box, idx)
        self._dtype = x.dtype
        dev = x.device
        rows_all = torch.arange(idx.shape[0], device=dev,
                                dtype=idx.dtype)[:, None]
        # only the legs inside the style's cutoff enter its energy: the rows
        # are compacted to them, which cuts the (rows, K, K) terms
        cut = self.max_cutoff
        live = (idx != rows_all) & (torch.sum(d_all * d_all, -1) < cut * cut)
        (d_all, jt_all), idx, _ = compact_legs(live, idx, rows_all,
                                               (d_all, jt_all))
        n, k = idx.shape
        it_all = type_.long()[:, None]
        f = torch.zeros_like(x)
        energy = torch.zeros((), dtype=x.dtype, device=dev)
        virial = torch.zeros(6, dtype=x.dtype, device=dev)
        step = self.rows_per_block(n, k)
        for b0 in range(0, n, step):
            b1 = min(n, b0 + step)
            rows = torch.arange(b0, b1, device=dev,
                                dtype=idx.dtype)[:, None]
            with torch.enable_grad():
                d = d_all[b0:b1].detach().requires_grad_(True)
                e = self.energy(d, it_all[b0:b1], jt_all[b0:b1],
                                idx[b0:b1], rows).to(x.dtype)
                (g,) = torch.autograd.grad(e, d)
            f[b0:b1] -= g.sum(dim=1)
            f.index_add_(0, idx[b0:b1].reshape(-1).long(),
                         g.reshape(-1, 3))
            energy = energy + e.detach()
            if vflag:
                dd = d.detach()
                virial = virial - torch.stack([
                    torch.sum(g[..., a] * dd[..., b])
                    for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                                 (1, 2))])
        return f, (energy if eflag else None), None, \
            (virial if vflag else None)


def compact_legs(live, idx, rows, tensors):
    """Each row's live slots first, the row cut to the most live slots of
    any row (one host read); the slots past a row's own live ones become
    padding (its own row index).  Returns (the tensors gathered along
    dim 1, the new idx, the new live mask).  The gather carries autograd's
    gradient back to the tensors it reads."""
    kc = max(1, int(live.sum(dim=1).max()))
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    order = order[:, :kc]
    keep = torch.gather(live, 1, order)
    new_idx = torch.where(keep, torch.gather(idx, 1, order), rows)
    out = []
    for t in tensors:
        o = order.reshape(order.shape + (1,) * (t.dim() - 2))
        out.append(torch.gather(t, 1, o.expand(order.shape + t.shape[2:])))
    return out, new_idx, keep


def pair_masks(d, idx, rows, cut):
    """(r2, in2): the squared lengths and the legs inside cut that are
    not padding: r2 < cut^2 (tpumd's and the reference's test) and
    sqrt(r2) < cut, since in f32 a leg just inside cut^2 can round to r =
    cut, where the styles' exp(a / (r - cut)) terms are 0 / 0."""
    r2 = torch.sum(d * d, -1)
    inside = (idx != rows) & (r2 < cut * cut)
    return r2, inside & (torch.sqrt(torch.where(inside, r2, 0.0)) < cut)


def _cos_jik(d, rs, inside):
    """cos(theta_jik) over each row's neighbour pairs (j, k): (B, K, K)."""
    rinv = torch.where(inside, 1.0 / rs, 0.0)
    dot = torch.einsum("nkc,nlc->nkl", d, d)
    return dot * rinv[:, :, None] * rinv[:, None, :]


def _samej(idx):
    return idx[:, :, None] == idx[:, None, :]


def _read_entries(path: str, nvals: int):
    """3-element keyed parameter entries (the sw, Tersoff-family,
    vashishta and edip file layout: e1 e2 e3 then nvals numbers; '#'
    starts a comment, entries run over lines)."""
    toks = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if line:
                toks.extend(line.split())
    entries = {}
    i = 0
    while i + 3 + nvals <= len(toks):
        e1, e2, e3 = toks[i:i + 3]
        entries[(e1, e2, e3)] = [float(v) for v in toks[i + 3:i + 3 + nvals]]
        i += 3 + nvals
    return entries


class _TripletFileStyle(EnergyPairStyle):
    """A style whose file holds one entry per element triplet:
    ``pair_coeff * * file El1 ... ElN`` maps each type to an element, or
    to NULL, which leaves the type out of the style."""

    _NAMES: list = []

    def settings(self):
        pass

    def coeff(self, ilo, ihi, jlo, jhi, filename, *elems):
        self.elements = [str(e) for e in elems]
        entries = _read_entries(str(filename), len(self._NAMES))
        nt = self.ntypes
        self.p = {nme: np.zeros((nt + 1,) * 3) for nme in self._NAMES}
        for i in range(1, nt + 1):
            for j in range(1, nt + 1):
                for k in range(1, nt + 1):
                    key = (self.elements[i - 1], self.elements[j - 1],
                           self.elements[k - 1])
                    if "NULL" in key:
                        # a type mapped to NULL (a hybrid's other
                        # sub-styles own it): its parameters stay 0, so
                        # its legs are outside every cutoff
                        continue
                    if key not in entries:
                        raise ValueError(f"pair_style {self.name}: no entry "
                                         f"{' '.join(key)} in {filename}")
                    for c, nme in enumerate(self._NAMES):
                        self.p[nme][i, j, k] = entries[key][c]
        on = np.asarray([e != "NULL" for e in self.elements])
        self._setflag[1:, 1:] = on[:, None] & on[None, :]

    def init(self):
        self.p["cut"] = self.p["R"] + self.p["D"]
        self.drop_tables()

    @property
    def max_cutoff(self):
        return float(self.p["cut"][1:, 1:, 1:].max())


@register_pair("sw")
class PairSW(_TripletFileStyle):
    """Stillinger-Weber: phi2 plus the angular phi3 over each central
    atom's neighbour pairs (src/MANYBODY/pair_sw.cpp).  File rows: e1 e2 e3
    epsilon sigma a lambda gamma costheta0 A B p q tol."""

    name = "sw"
    _NAMES = ["epsilon", "sigma", "a", "lambda", "gamma", "costheta0",
              "A", "B", "p", "q", "tol"]

    def init(self):
        self.p["cut"] = self.p["sigma"] * self.p["a"]
        self.drop_tables()

    def energy(self, d, it, jt, idx, rows):
        tp = self._tp
        cij = tp("cut", it, jt, jt)
        r2, in2 = pair_masks(d, idx, rows, cij)
        r = torch.sqrt(torch.where(in2, r2, 1.0))
        rs = torch.where(in2, r, cij - 1.0)   # keeps the exp finite
        sij = tp("sigma", it, jt, jt)
        eps = tp("epsilon", it, jt, jt)
        phi2 = (tp("A", it, jt, jt) * eps
                * (tp("B", it, jt, jt) * (sij / rs) ** tp("p", it, jt, jt)
                   - (sij / rs) ** tp("q", it, jt, jt))
                * torch.exp(sij / (rs - cij)))
        e2 = 0.5 * torch.sum(torch.where(in2, phi2, 0.0))
        # the legs g_ij take params (i, j, j) (elem3param(i, j, j))
        gleg = torch.where(
            in2, torch.exp(tp("gamma", it, jt, jt) * sij / (rs - cij)), 0.0)
        cs = _cos_jik(d, rs, in2)
        i3, j3, k3 = it[:, :, None], jt[:, :, None], jt[:, None, :]
        delc = cs - tp("costheta0", i3, j3, k3)
        tmask = in2[:, :, None] & in2[:, None, :] & ~_samej(idx)
        phi3 = (tp("lambda", i3, j3, k3) * tp("epsilon", i3, j3, k3)
                * delc * delc * gleg[:, :, None] * gleg[:, None, :])
        return e2 + 0.5 * torch.sum(torch.where(tmask, phi3, 0.0))


def _fc_tersoff(rr, R_, D_):
    """ters_fc: 1 below R-D, 0 past R+D, a half sine between."""
    return torch.where(
        rr < R_ - D_, 1.0,
        torch.where(rr > R_ + D_, 0.0,
                    0.5 * (1.0 - torch.sin(0.5 * np.pi * (rr - R_) / D_))))


def ters_bij(bz, nn):
    """The reference's 5-branch bond order (PairTersoff::ters_bij,
    src/MANYBODY/pair_tersoff.cpp:300-310) with c1..c4 = ((2n 1e-16)^-1/n,
    (2n 1e-8)^-1/n, 1/c2, 1/c1).  Each branch reads bz clamped to its own
    range, so an unselected branch neither overflows nor sends a NaN back
    (tpumd evaluates every branch at max(bz, 1e-30): at zeta -> 0 its
    bz^-n overflows and its gradient is NaN; the reference evaluates only
    the branch it takes)."""
    c1 = (2.0 * nn * 1.0e-16) ** (-1.0 / nn)
    c2 = (2.0 * nn * 1.0e-8) ** (-1.0 / nn)
    c3 = 1.0 / c2
    c4 = 1.0 / c1
    b_hi = torch.clamp(bz, min=c1)
    b_hi2 = torch.clamp(bz, min=c2, max=c1)
    b_lo2 = torch.clamp(bz, min=c4, max=c3)
    b_mid = torch.clamp(bz, min=c3, max=c2)
    hi = 1.0 / torch.sqrt(b_hi)
    hi2 = (1.0 - b_hi2 ** (-nn) / (2.0 * nn)) / torch.sqrt(b_hi2)
    lo2 = 1.0 - b_lo2 ** nn / (2.0 * nn)
    central = (1.0 + b_mid ** nn) ** (-1.0 / (2.0 * nn))
    return torch.where(
        bz > c1, hi,
        torch.where(bz > c2, hi2,
                    torch.where(bz < c4, 1.0,
                                torch.where(bz < c3, lo2, central))))


def _ex_delr(m_, arg):
    """exp(arg^3) where m = 3, else exp(arg), capped at 1e30."""
    if isinstance(m_, float):
        ex = torch.exp(arg ** 3) if m_ == 3.0 else torch.exp(arg)
    else:
        ex = torch.where(m_ == 3, torch.exp(arg ** 3), torch.exp(arg))
    return torch.clamp(ex, max=1.0e30)


class _TersoffBase(_TripletFileStyle):
    """The Tersoff family's shared legs: the pair masks, fc over each leg,
    and the zeta sum over each central atom's neighbour pairs."""

    def _fc(self, rr, R_, D_):
        return _fc_tersoff(rr, R_, D_)

    def _gtheta(self, cs, i3, j3, k3):
        tp = self._tp
        c_, d_ = tp("c", i3, j3, k3), tp("d", i3, j3, k3)
        h_ = tp("h", i3, j3, k3)
        return tp("gamma", i3, j3, k3) * (
            1.0 + c_ * c_ / (d_ * d_) - c_ * c_ / (d_ * d_ + (cs - h_) ** 2))

    def _legs(self, d, it, jt, idx, rows):
        tp = self._tp
        R, D = tp("R", it, jt, jt), tp("D", it, jt, jt)
        r2, in2 = pair_masks(d, idx, rows, R + D)
        rs = torch.where(in2, torch.sqrt(torch.where(in2, r2, 1.0)),
                         R + D + 1.0)
        fc_ij = torch.where(in2, self._fc(rs, R, D), 0.0)
        return in2, rs, fc_ij

    def _zeta(self, d, it, jt, idx, in2, rs):
        tp = self._tp
        i3, j3, k3 = it[:, :, None], jt[:, :, None], jt[:, None, :]
        # leg ik's cutoff takes params (i, k, k); the angular ones (i, j, k)
        r_ik = rs[:, None, :]
        in_ik = in2[:, None, :]
        fc_ik = torch.where(in_ik, self._fc(r_ik, tp("R", i3, k3, k3),
                                            tp("D", i3, k3, k3)), 0.0)
        cs = _cos_jik(d, rs, in2)
        gtheta = self._gtheta(cs, i3, j3, k3)
        arg = tp("lam3", i3, j3, k3) * (rs[:, :, None] - r_ik)
        ex_delr = _ex_delr(tp("m", i3, j3, k3), arg)
        zmask = in2[:, :, None] & in_ik & ~_samej(idx)
        return torch.sum(torch.where(zmask, fc_ik * gtheta * ex_delr, 0.0),
                         dim=2)


@register_pair("tersoff")
class PairTersoff(_TersoffBase):
    """Tersoff bond-order potential (src/MANYBODY/pair_tersoff.cpp).  File
    rows: e1 e2 e3 m gamma lambda3 c d costheta0 n beta lambda2 B R D
    lambda1 A."""

    name = "tersoff"
    _NAMES = ["m", "gamma", "lam3", "c", "d", "h", "n", "beta",
              "lam2", "B", "R", "D", "lam1", "A"]

    def energy(self, d, it, jt, idx, rows):
        tp = self._tp
        in2, rs, fc_ij = self._legs(d, it, jt, idx, rows)
        f_rep = tp("A", it, jt, jt) * torch.exp(-tp("lam1", it, jt, jt) * rs)
        f_att = -tp("B", it, jt, jt) * torch.exp(-tp("lam2", it, jt, jt)
                                                 * rs)
        zeta = self._zeta(d, it, jt, idx, in2, rs)
        b_ij = ters_bij(tp("beta", it, jt, jt) * zeta, tp("n", it, jt, jt))
        return 0.5 * torch.sum(
            torch.where(in2, fc_ij * (f_rep + b_ij * f_att), 0.0))


@register_pair("tersoff/mod")
class PairTersoffMod(_TersoffBase):
    """Tersoff/MOD (Kumagai) bond order (src/MANYBODY/pair_tersoff_mod.cpp).
    File rows: e1 e2 e3 beta(m) alpha(lam3) h eta(n) beta lam2 B R D lam1 A
    n(delta) c1 c2 c3 c4 c5; fc is the 1.125/0.125 double-sine window,
    g(theta) the c1..c5 form, b_ij = (1 + (beta zeta)^eta)^(-1/(2 delta))."""

    name = "tersoff/mod"
    _NAMES = ["m", "lam3", "h", "n", "beta", "lam2", "B", "R", "D",
              "lam1", "A", "ndel", "c1", "c2", "c3", "c4", "c5"]

    def _fc(self, rr, R_, D_):
        t = 0.5 * np.pi * (rr - R_) / D_
        return torch.where(
            rr < R_ - D_, 1.0,
            torch.where(rr > R_ + D_, 0.0,
                        0.5 * (1.0 - 1.125 * torch.sin(t)
                               - 0.125 * torch.sin(3.0 * t))))

    def _gtheta(self, cs, i3, j3, k3):
        tp = self._tp
        th = (tp("h", i3, j3, k3) - cs) ** 2
        return tp("c1", i3, j3, k3) + (
            tp("c2", i3, j3, k3) * th / (tp("c3", i3, j3, k3) + th)) * (
            1.0 + tp("c4", i3, j3, k3) * torch.exp(-tp("c5", i3, j3, k3)
                                                   * th))

    def energy(self, d, it, jt, idx, rows):
        tp = self._tp
        in2, rs, fc_ij = self._legs(d, it, jt, idx, rows)
        f_rep = tp("A", it, jt, jt) * torch.exp(-tp("lam1", it, jt, jt) * rs)
        f_att = -tp("B", it, jt, jt) * torch.exp(-tp("lam2", it, jt, jt)
                                                 * rs)
        zeta = self._zeta(d, it, jt, idx, in2, rs)
        bz = tp("beta", it, jt, jt) * zeta
        b_ij = (1.0 + bz ** tp("n", it, jt, jt)) ** (
            -1.0 / (2.0 * tp("ndel", it, jt, jt)))
        return 0.5 * torch.sum(
            torch.where(in2, fc_ij * (f_rep + b_ij * f_att), 0.0))


@register_pair("tersoff/zbl")
class PairTersoffZBL(PairTersoff):
    """Tersoff with the ZBL universal repulsion blended in by a Fermi
    switch (src/MANYBODY/pair_tersoff_zbl.cpp:185-233): the repulsive term
    is (1-F) E_ZBL + F fc A e^{-lam1 r} with F = 1/(1+e^{-A_f (r - r_C)}),
    and the attractive term carries F too."""

    name = "tersoff/zbl"
    _NAMES = PairTersoff._NAMES + ["Zi", "Zj", "zblcut", "zblexp"]
    # metal-units ZBL constants (pair_tersoff_zbl.cpp:50-52)
    _a0 = 0.529
    _eps0 = 0.00552635

    def energy(self, d, it, jt, idx, rows):
        tp = self._tp
        in2, rs, fc_ij = self._legs(d, it, jt, idx, rows)
        e_ters = fc_ij * tp("A", it, jt, jt) * torch.exp(
            -tp("lam1", it, jt, jt) * rs)
        zi, zj = tp("Zi", it, jt, jt), tp("Zj", it, jt, jt)
        a_ij = (0.8854 * self._a0) / (zi ** 0.23 + zj ** 0.23)
        premult = zi * zj / (4.0 * np.pi * self._eps0)
        roa = rs / a_ij
        phi = (0.1818 * torch.exp(-3.2 * roa)
               + 0.5099 * torch.exp(-0.9423 * roa)
               + 0.2802 * torch.exp(-0.4029 * roa)
               + 0.02817 * torch.exp(-0.2016 * roa))
        e_zbl = premult * phi / rs
        F = 1.0 / (1.0 + torch.exp(-tp("zblexp", it, jt, jt)
                                   * (rs - tp("zblcut", it, jt, jt))))
        e_rep = (1.0 - F) * e_zbl + F * e_ters
        f_att = -tp("B", it, jt, jt) * torch.exp(
            -tp("lam2", it, jt, jt) * rs) * F
        zeta = self._zeta(d, it, jt, idx, in2, rs)
        b_ij = ters_bij(tp("beta", it, jt, jt) * zeta, tp("n", it, jt, jt))
        return 0.5 * torch.sum(
            torch.where(in2, e_rep + b_ij * fc_ij * f_att, 0.0))


@register_pair("vashishta")
class PairVashishta(_TripletFileStyle):
    """Vashishta 2+3 body potential (src/MANYBODY/pair_vashishta.cpp).
    Two-body, shifted so that V and V' vanish at rc:
      H/r^eta + Zi Zj qqr2e e^{-r/l1}/r - D e^{-r/l4}/r^4 - W/r^6
      - vrc - (r - rc) dvrc;
    three-body for legs under r0:
      B exp(g/(r1-r0) + g/(r2-r0)) dcos^2/(1 + C dcos^2).
    File rows: e1 e2 e3 H eta Zi Zj lambda1 D lambda4 W rc B gamma r0 C
    costheta.  vrc and dvrc (setup_params) are made on the host at set-up,
    dvrc in closed form."""

    name = "vashishta"
    _NAMES = ["H", "eta", "Zi", "Zj", "lam1", "Dd", "lam4", "W",
              "rc", "B", "gamma", "r0", "C", "costh"]
    qqr2e = 14.399645   # metal units, as in tpumd

    def init(self):
        p = self.p
        self.p["cut"] = p["rc"]
        with np.errstate(divide="ignore", invalid="ignore"):
            l1inv = np.where(p["lam1"] != 0, 1.0 / np.where(
                p["lam1"] != 0, p["lam1"], 1.0), 0.0)
            l4inv = np.where(p["lam4"] != 0, 1.0 / np.where(
                p["lam4"] != 0, p["lam4"], 1.0), 0.0)
            rc = np.where(p["rc"] > 0, p["rc"], 1.0)
            zz = p["Zi"] * p["Zj"] * self.qqr2e
            e1, e4 = np.exp(-rc * l1inv), np.exp(-rc * l4inv)
            vrc = (p["H"] * rc ** (-p["eta"]) + zz * e1 / rc
                   - p["Dd"] * e4 / rc ** 4 - p["W"] / rc ** 6)
            dvrc = (-p["eta"] * p["H"] * rc ** (-p["eta"] - 1.0)
                    + zz * e1 * (-l1inv / rc - 1.0 / rc ** 2)
                    - p["Dd"] * e4 * (-l4inv / rc ** 4 - 4.0 / rc ** 5)
                    + 6.0 * p["W"] / rc ** 7)
        live = p["rc"] > 0
        self.p["l1inv"], self.p["l4inv"] = l1inv, l4inv
        self.p["vrc"] = np.where(live, vrc, 0.0)
        self.p["dvrc"] = np.where(live, dvrc, 0.0)
        self.drop_tables()

    def energy(self, d, it, jt, idx, rows):
        tp = self._tp

        def pij(nme):
            return tp(nme, it, jt, jt)

        rc = pij("rc")
        r2, in2 = pair_masks(d, idx, rows, rc)
        r = torch.sqrt(torch.where(in2, r2, 1.0))
        rs = torch.where(in2, r, rc + 1.0)
        zizj = pij("Zi") * pij("Zj") * self.qqr2e
        v2 = (pij("H") * rs ** (-pij("eta"))
              + zizj * torch.exp(-rs * pij("l1inv")) / rs
              - pij("Dd") * torch.exp(-rs * pij("l4inv")) / rs ** 4
              - pij("W") / rs ** 6)
        e2 = v2 - pij("vrc") - (rs - rc) * pij("dvrc")
        e = 0.5 * torch.sum(torch.where(in2, e2, 0.0))

        # the three-body legs are those under r0: the rows are compacted to
        # them before the (rows, K, K) terms
        _, in3 = pair_masks(d, idx, rows, pij("r0"))
        (d, jt, rs), idx, in3 = compact_legs(in3, idx, rows, (d, jt, rs))
        r0ij = tp("r0", it, jt, jt)
        gs = tp("gamma", it, jt, jt) / torch.where(in3, rs - r0ij, -1.0)
        expg = torch.where(in3, torch.exp(gs), 0.0)
        i3, j3, k3 = it[:, :, None], jt[:, :, None], jt[:, None, :]
        cs = _cos_jik(d, rs, in3)
        dcs = cs - tp("costh", i3, j3, k3)
        dcs2 = dcs * dcs
        pcs = dcs2 / (1.0 + tp("C", i3, j3, k3) * dcs2)
        zmask = in3[:, :, None] & in3[:, None, :] & ~_samej(idx)
        e3 = tp("B", i3, j3, k3) * expg[:, :, None] * expg[:, None, :] * pcs
        # each (j, k) pair is counted twice in the ordered double sum
        return e + 0.5 * torch.sum(torch.where(zmask, e3, 0.0))


@register_pair("atm")
class PairATM(EnergyPairStyle):
    """Axilrod-Teller-Muto triple-dipole dispersion
    (src/MANYBODY/pair_atm.cpp:353-375).  Per triangle (i, j, k):
    E = nu (r6 - 3 (rik.rij)(rij.rjk)(rjk.rik)) / r6^{5/2} with r6 =
    rij^2 rjk^2 rik^2, counted where every leg is inside the cutoff and
    r6 <= cut_triple^6.  The ordered double sum over each central atom's
    neighbours visits each triangle 6 times, so the total divides by 6;
    nu is symmetric over the 6 type permutations (init_one)."""

    name = "atm"
    kk_weight = 3

    def settings(self, cut_global, cut_triple):
        self.cut_global = float(cut_global)
        self.cut_triple = float(cut_triple)
        self.p = {"nu": np.zeros((self.ntypes + 1,) * 3)}

    def coeff(self, ilo, ihi, jlo, jhi, kspec, nu_one):
        nt = self.ntypes
        ks = str(kspec)
        if ks == "*":
            klo, khi = 1, nt
        elif ks.endswith("*"):
            klo, khi = int(float(ks[:-1])), nt
        elif ks.startswith("*"):
            klo, khi = 1, int(float(ks[1:]))
        else:
            klo = khi = int(float(ks))
        v = float(nu_one)
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                for k in range(max(klo, j), khi + 1):
                    for pm in permutations((i, j, k)):
                        self.p["nu"][pm] = v
                self._setflag[i, j] = True

    def init(self):
        self.drop_tables()

    @property
    def max_cutoff(self):
        return self.cut_global

    def energy(self, d, it, jt, idx, rows):
        c2 = self.cut_global * self.cut_global
        r2, leg = pair_masks(d, idx, rows, self.cut_global)
        # the triangle's legs: ij from slot a, ik from slot b, jk = d_b - d_a
        djk = d[:, None, :, :] - d[:, :, None, :]
        rjk2 = torch.sum(djk * djk, -1)
        tmask = (leg[:, :, None] & leg[:, None, :] & ~_samej(idx)
                 & (rjk2 < c2))
        r6 = r2[:, :, None] * rjk2 * r2[:, None, :]
        ct3 = self.cut_triple ** 3
        tmask = tmask & (r6 <= ct3 * ct3)
        nu3 = self._tp("nu", it[:, :, None], jt[:, :, None], jt[:, None, :])
        if isinstance(nu3, float):
            if nu3 == 0.0:
                return torch.zeros((), dtype=d.dtype, device=d.device)
        else:
            tmask = tmask & (nu3 != 0.0)
        r6s = torch.where(tmask, r6, 1.0)
        r5inv = nu3 / (r6s * r6s * torch.sqrt(r6s))
        rri = torch.einsum("nbc,nac->nab", d, d)           # rik . rij
        rrj = torch.sum(d[:, :, None, :] * djk, -1)        # rij . rjk
        rrk = torch.sum(djk * d[:, None, :, :], -1)        # rjk . rik
        eng = (r6s - 0.6 * (5.0 * rri * rrj * rrk)) * r5inv
        return torch.sum(torch.where(tmask, eng, 0.0)) / 6.0


_EDIP_NAMES = ["A", "B", "cutoffA", "cutoffC", "alpha", "beta", "eta",
               "gamma", "lambda", "mu", "rho", "sigma", "Q0",
               "u1", "u2", "u3", "u4"]


def _read_edip_file(path: str, element: str):
    """The el el el entry of an EDIP file: 17 values
    (PairEDIP::read_file, src/MANYBODY/pair_edip.cpp:783-840)."""
    entries = _read_entries(path, len(_EDIP_NAMES))
    key = (element,) * 3
    if key not in entries:
        raise ValueError(f"EDIP entry for {element} not found in {path}")
    return dict(zip(_EDIP_NAMES, entries[key]))


@register_pair("edip")
class PairEDIP(EnergyPairStyle):
    """EDIP (Justo et al.) for one element (src/MANYBODY/pair_edip.cpp):
      E = sum over ordered pairs A e^{sigma/(r-a)} [(B/r)^rho - e^{-beta
      Z_i^2}] + sum_i sum_{j<k} e^{gamma/(r_ij-a)} e^{gamma/(r_ik-a)}
      h(cos, Z_i),
    h(c, Z) = lambda [(1 - e^{-Q (c+tau)^2}) + eta Q (c+tau)^2], Q(Z) =
    Q0 e^{-mu Z}, tau(Z) = u1 + u2 u3 e^{-u4 Z} - u2 e^{-2 u4 Z}, and the
    coordination Z_i = sum f_c(r).  The reference interpolates these
    functions on grids (initGrids); here, as in tpumd, they are evaluated
    in closed form."""

    name = "edip"

    def settings(self):
        pass

    def coeff(self, ilo, ihi, jlo, jhi, filename, *elems):
        if self.ntypes != 1 or len(set(elems)) != 1:
            raise ValueError("pair_style edip: single element only "
                             "(the reference's pair_edip has the same "
                             "limit; edip/multi is not ported)")
        self.p = _read_edip_file(str(filename), str(elems[0]))
        self._setflag[1, 1] = True

    def init(self):
        pass

    @property
    def max_cutoff(self):
        return float(self.p["cutoffA"])

    def energy(self, d, it, jt, idx, rows):
        p = self.p
        a_cut, c_cut = p["cutoffA"], p["cutoffC"]
        r2, inside = pair_masks(d, idx, rows, a_cut)
        r = torch.sqrt(torch.where(inside, r2, 1.0))
        rs = torch.where(inside, r, a_cut + 1.0)
        # the coordination Z_i
        frac = torch.clamp((rs - c_cut) / (a_cut - c_cut), min=1e-12)
        x3 = frac ** (-3.0)
        fcut = torch.where(rs < c_cut, 1.0,
                           torch.where(inside & (rs < a_cut),
                                       torch.exp(p["alpha"] / (1.0 - x3)),
                                       0.0))
        Z = torch.sum(torch.where(inside, fcut, 0.0), dim=1)
        tau = (p["u1"] + p["u2"] * p["u3"] * torch.exp(-p["u4"] * Z)
               - p["u2"] * torch.exp(-2.0 * p["u4"] * Z))
        Q = p["Q0"] * torch.exp(-p["mu"] * Z)
        embz = torch.exp(-p["beta"] * Z * Z)
        # two-body over ordered pairs, Z of the central atom
        exp2b = p["A"] * torch.exp(p["sigma"] / (rs - a_cut))
        pow2b = (p["B"] / rs) ** p["rho"]
        e2 = torch.sum(torch.where(inside, exp2b * (pow2b - embz[:, None]),
                                   0.0))
        # three-body over each row's neighbour pairs, ordered / 2
        exp3b = torch.where(inside, torch.exp(p["gamma"] / (rs - a_cut)),
                            0.0)
        cs = _cos_jik(d, rs, inside)
        ctd = cs + tau[:, None, None]
        qc2 = Q[:, None, None] * ctd * ctd
        h = p["lambda"] * ((1.0 - torch.exp(-qc2)) + p["eta"] * qc2)
        tmask = inside[:, :, None] & inside[:, None, :] & ~_samej(idx)
        return e2 + 0.5 * torch.sum(torch.where(
            tmask, exp3b[:, :, None] * exp3b[:, None, :] * h, 0.0))
