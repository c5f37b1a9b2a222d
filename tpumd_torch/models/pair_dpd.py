"""DPD pair styles: dpd and dpd/tstat (src/DPD-BASIC/pair_dpd.cpp:71-182,
pair_dpd_tstat.cpp).

PyTorch counterpart of tpumd/models/pair_dpd.py on the matrix neighbor
engine: the conservative soft repulsion a0 (1 - r/rc), the pairwise drag
-gamma wd^2 (v_ij . e_ij) and the random kick sigma wd theta / sqrt(dt),
sigma = sqrt(2 kB T gamma).  The neighbours' positions, velocities, tags
and types come in one row gather (P1) of a packed (x, v, tag, type) table,
their coefficients in another (``pair_coeffs``).

The per-pair standard normal theta is tpumd's stateless counter hash: the
murmur3 finalizer over (min tag, max tag, step, seed) feeds a Box-Muller
transform, symmetric in i and j, so Newton's third law holds with no
communication.  The reference draws a serial RanMars stream instead, so a
thermostatted trajectory is an ensemble match, not a bitwise one; the
conservative part (gamma = 0) is deterministic.  The 32-bit words are
computed in int64 and kept to their low 32 bits, each product split in
16-bit halves so that no int64 product overflows; they equal tpumd's
uint32 words bit for bit.  The uniforms are float32 as tpumd makes them,
even in a float64 run; the logarithm, square root and cosine are taken in
float64 and rounded to float32, so the normals are the correctly rounded
values of tpumd's float32 recipe on every device (XLA's and CUDA's
float32 log and cos, and PyTorch's CPU float32 sqrt, are within one ulp
of them, not bitwise equal: ROADMAP C29).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image_c
from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows

M32 = 0xFFFFFFFF


def mul32(h, c: int):
    """(h * c) mod 2^32 of int64 words h in [0, 2^32) and a 32-bit
    constant c, with every intermediate below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32


def murmur_fmix(h):
    """The murmur3 32-bit finalizer (tpumd/models/pair_dpd.py:32-37)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def pair_words(tagi, tagj, step: int, seed: int):
    """The two 32-bit words (int64 in [0, 2^32)) of each (i, j) pair
    (tpumd/models/pair_dpd.py:40-51)."""
    lo = torch.minimum(tagi, tagj).to(torch.int64)
    hi = torch.maximum(tagi, tagj).to(torch.int64)
    base = (mul32(lo, 0x9E3779B1) ^ mul32(hi, 0x85EBCA77)
            ^ mul32(int(step) & M32, 0xC2B2AE3D) ^ (int(seed) & M32))
    return murmur_fmix(base), murmur_fmix(base ^ 0x5BD1E995)


def pair_gaussian(tagi, tagj, step: int, seed: int):
    """Standard normals of broadcastable tagi, tagj, float32, symmetric
    under i <-> j (tpumd/models/pair_dpd.py:40-56)."""
    u1, u2 = pair_words(tagi, tagj, step, seed)
    scale = np.float32(2.3283064e-10)
    f1 = (u1.to(torch.float32) + 1.0) * scale
    f2 = u2.to(torch.float32) * scale
    f64, f32 = torch.float64, torch.float32
    log = torch.log(f1.to(f64)).to(f32)
    r = torch.sqrt((-2.0 * log).to(f64)).to(f32)
    return r * torch.cos((np.float32(2.0 * np.pi) * f2).to(f64)).to(f32)


@register_pair("dpd")
class PairDPD(PairStyle):
    name = "dpd"
    needs_velocities = True
    supports_image_ext = False
    peratom = False
    tstat_only = False

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        shape = (ntypes + 1, ntypes + 1)
        self.a0 = np.zeros(shape)
        self.gamma = np.zeros(shape)
        self.cut = np.zeros(shape)

    def settings(self, temperature, cut_global, seed):
        self.temperature = float(temperature)
        self.t_start = self.t_stop = self.temperature
        self.cut_global = float(cut_global)
        self.seed = int(seed) % (2**31)

    def coeff(self, ilo, ihi, jlo, jhi, a0, gamma, cut=None):
        self._set(ilo, ihi, jlo, jhi, a0, gamma, cut)

    def _set(self, ilo, ihi, jlo, jhi, a0, gamma, cut):
        cut = self.cut_global if cut is None else float(cut)
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.a0[i, j] = float(a0)
                self.gamma[i, j] = float(gamma)
                self.cut[i, j] = cut
                self._setflag[i, j] = True

    def init(self):
        """Unset i-j pairs take the arithmetic means of i-i and j-j, as
        tpumd does (the reference requires them set)."""
        nt = self.ntypes
        for i in range(1, nt + 1):
            for j in range(i, nt + 1):
                if not self._setflag[i, j]:
                    if not (self._setflag[i, i] and self._setflag[j, j]):
                        raise ValueError(
                            f"All pair coeffs are not set ({i},{j})")
                    for arr in (self.a0, self.gamma, self.cut):
                        arr[i, j] = 0.5 * (arr[i, i] + arr[j, j])
                for arr in (self.a0, self.gamma, self.cut):
                    arr[j, i] = arr[i, j]
        self.cutsq = self.cut * self.cut
        self.drop_tables()

    @property
    def max_cutoff(self) -> float:
        return float(self.cut[1:, 1:].max())

    def compute_vel(self, s, neigh, ctx, eflag: bool, vflag: bool,
                    istep: int):
        """(f, evdwl or None, virial or None) with the random kick of
        timestep istep (tpumd/models/pair_dpd.py:108-176)."""
        idx, sbits = neigh.idx, neigh.sbits
        x, v = s.x, s.v
        dt_ = x.dtype
        n = idx.shape[0]
        mask = idx != torch.arange(n, dtype=idx.dtype,
                                   device=x.device)[:, None]
        packed = torch.cat([x, v, s.tag.to(dt_)[:, None],
                            s.type.to(dt_)[:, None]], dim=1)
        pj = gather_rows(packed, idx)                    # (N, K, 8)
        tagj = pj[..., 6].to(torch.int32)
        tj = pj[..., 7].to(torch.int32)
        ti = s.type[:, None]
        d = [minimum_image_c(x[:, c:c + 1] - pj[..., c], s.box, c)
             for c in range(3)]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        cutsq, cut, gamma, a0 = self.pair_coeffs(rsq, ti, tj, "cutsq", "cut",
                                                 "gamma", "a0")
        inrange = mask & (rsq < cutsq) & (rsq > 1e-24)
        r = torch.sqrt(torch.where(inrange, rsq, 1.0))
        rinv = 1.0 / r
        wd = 1.0 - r / cut
        dot = sum((v[:, c:c + 1] - pj[..., 3 + c]) * d[c] for c in range(3))
        kbt = self.temperature * ctx.units.boltz
        sigma = torch.sqrt(2.0 * kbt * gamma)
        theta = pair_gaussian(s.tag[:, None], tagj, istep, self.seed).to(dt_)
        # special pairs take the LJ weights (code 0: weight 1)
        w = torch.as_tensor(ctx.special_lj, dtype=dt_,
                            device=x.device)[sbits.long()]
        fpair = torch.zeros_like(rsq) if self.tstat_only else a0 * wd
        fpair = fpair - gamma * wd * wd * dot * rinv
        fpair = fpair + sigma * wd * theta * (1.0 / np.sqrt(ctx.dt))
        fpair = torch.where(inrange, w * fpair * rinv, 0.0)
        f = torch.stack([torch.sum(fpair * d[c], dim=1) for c in range(3)],
                        dim=1)
        evdwl = virial = None
        if eflag:
            evdwl = x.new_zeros(()) if self.tstat_only else 0.5 * torch.sum(
                torch.where(inrange, w * 0.5 * a0 * cut * wd * wd, 0.0))
        if vflag:
            virial = 0.5 * torch.stack([
                torch.sum(fpair * d[a] * d[b])
                for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                             (1, 2))])
        return f, evdwl, virial


@register_pair("dpd/tstat")
class PairDPDTstat(PairDPD):
    """pair dpd/tstat: the thermostat alone, no conservative force, at
    t_start (tpumd/models/pair_dpd.py:181-210 keeps t_start over the
    run)."""

    name = "dpd/tstat"
    tstat_only = True

    def settings(self, t_start, t_stop, cut_global, seed):
        self.t_start = float(t_start)
        self.t_stop = float(t_stop)
        self.temperature = self.t_start
        self.cut_global = float(cut_global)
        self.seed = int(seed) % (2**31)

    def coeff(self, ilo, ihi, jlo, jhi, gamma, cut=None):
        self._set(ilo, ihi, jlo, jhi, 0.0, gamma, cut)
