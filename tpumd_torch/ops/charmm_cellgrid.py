"""lj/charmm/coul/long on the cell grid: the CUDA kernel, its wrapper and
its plain PyTorch versions.

The kernel (``tpumd_torch/csrc/charmm_cellgrid.cu``) replaces the TPU
kernel tpumd/ops/pallas_charmm.py::_kernel (entry
charmm_cellgrid_forces_pallas): CHARMM-switched LJ, real-space Ewald
Coulomb through the reference's erfc polynomial, and the 1-2/1-3/1-4
special weights, with the kspace exclusion correction of excluded Coulomb
pairs.  It sweeps the grid's pair list (``ops/cellgrid_pairlist.py``,
built at every re-bin), whose entries carry each pair's special code, at
the minimum image of the current box.  It also writes per-slot van der
Waals and Coulomb energies and the virial, so thermo steps need no second
sweep.  ``charmm_cellgrid`` launches it for CUDA tensors and takes the
plain list sweep (``charmm_pairlist_plain``) only for CPU tensors; it never
falls back from one to the other.  With ``rows`` (B5-rows, a rank's owned
atoms on its local grid, parallel/decomp.py) the kernel sweeps those slots'
rows only, taking the image as B1 does (x_i - (x_j + s)), the other slots'
forces 0, the energies and virial those rows' sums; its plain version
sweeps the same rows through ``list_entries``.  ``charmm_cellgrid_plain``,
the sweep over the 27-cell stencil that matches special tags pair by pair,
is the oracle the list sweep is held to; no run calls it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, cellgrid_pair_sums
from tpumd_torch.ops.cellgrid_pairlist import unpack
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, peratom_flags
from tpumd_torch.ops.pairwise import pair_sums

# the reference's erfc approximation (src/KSPACE/pair_lj_charmm_coul_
# long.cpp:37, tpumd/models/pair_charmm.py:20-23)
EWALD_F = 1.12837917
EWALD_P = 0.3275911
A1, A2, A3, A4, A5 = (0.254829592, -0.284496736, 1.421413741,
                      -1.453152027, 1.061405429)


class CharmmCoeffs(NamedTuple):
    """Everything the lj/charmm/coul/long sweep reads besides the atoms."""
    lj: torch.Tensor      # (4, nt+1, nt+1): lj1..lj4, in x's dtype, on x's device
    qqrd2e: float
    g_ewald: float
    cut_coulsq: float
    cut_ljsq: float
    cut_lj_innersq: float
    denom_lj: float       # (cut_ljsq - cut_lj_innersq)^3
    w_lj: tuple           # special_bonds lj weights by code 0..3 (code 0: 1)
    w_coul: tuple         # the same for Coulomb


counts = LaunchCounts()


def charmm_pair_fn(c: CharmmCoeffs):
    """(fpair, evdwl, ecoul, fcoul) per pair, pre-weighted by the special
    weights: tpumd/models/pair_charmm.py::pair_fn_ex.  An excluded pair
    in Coulomb range keeps -(1 - w_coul) * prefactor, the kspace
    exclusion correction (src/KSPACE/pair_lj_charmm_coul_long.cpp:120)."""

    def pair_fn(r2, itype, jtype, w_lj, w_coul, qi, qj):
        it, jt = itype.long(), jtype.long()
        lj1, lj2, lj3, lj4 = (c.lj[k][it, jt] for k in range(4))
        r2inv = 1.0 / r2
        in_coul = r2 < c.cut_coulsq
        r = torch.sqrt(r2)
        grij = c.g_ewald * r
        expm2 = torch.exp(-grij * grij)
        t = 1.0 / (1.0 + EWALD_P * grij)
        erfc = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2
        prefactor = c.qqrd2e * qi * qj / r
        forcecoul = prefactor * (erfc + EWALD_F * grij * expm2)
        forcecoul = forcecoul - (1.0 - w_coul) * prefactor
        ecoul = prefactor * erfc - (1.0 - w_coul) * prefactor
        forcecoul = torch.where(in_coul, forcecoul, 0.0)
        ecoul = torch.where(in_coul, ecoul, 0.0)

        in_lj = r2 < c.cut_ljsq
        r6inv = r2inv * r2inv * r2inv
        forcelj = r6inv * (lj1 * r6inv - lj2)
        philj = r6inv * (lj3 * r6inv - lj4)
        sw_on = r2 > c.cut_lj_innersq
        tt = c.cut_ljsq - r2
        switch1 = (tt * tt * (c.cut_ljsq + 2.0 * r2 - 3.0 * c.cut_lj_innersq)
                   / c.denom_lj)
        switch2 = 12.0 * r2 * tt * (r2 - c.cut_lj_innersq) / c.denom_lj
        forcelj = torch.where(sw_on, forcelj * switch1 + philj * switch2,
                              forcelj)
        philj = torch.where(sw_on, philj * switch1, philj)
        forcelj = torch.where(in_lj, forcelj * w_lj, 0.0)
        evdwl = torch.where(in_lj, philj * w_lj, 0.0)
        return forcelj * r2inv, evdwl, ecoul, forcecoul * r2inv

    return pair_fn


def special_weights(scodes, c: CharmmCoeffs, like):
    """(w_lj, w_coul) (Np, S) of each special entry from its code."""
    def table(w):
        return torch.tensor(w, dtype=like.dtype, device=like.device)
    idx = scodes.long()
    return table(c.w_lj)[idx], table(c.w_coul)[idx]


def charmm_cellgrid_plain(x, q, type_, valid, tag, stags, scodes, box: Box,
                          cfg: CellGridConfig, c: CharmmCoeffs, eflag: bool,
                          vflag: bool):
    """The stencil oracle: (f, evdwl, ecoul, virial) summed over the
    27-cell stencil, special weights matched against each i slot's
    special tags.  Blocks of at most 2^22 candidates on the CPU (memory),
    2^26 on a card."""
    wl, wc = special_weights(scodes, c, x)
    f, evdwl, virial, ecoul = cellgrid_pair_sums(
        x, type_, valid, box, cfg, charmm_pair_fn(c), eflag, vflag, q=q,
        special=(tag, stags, wl, wc),
        cutsq=max(c.cut_coulsq, c.cut_ljsq),
        max_pairs=1 << (22 if x.device.type == "cpu" else 26))
    return f, evdwl, ecoul, virial


def charmm_rows_plain(x, q, type_, pairs, npairs, box: Box,
                      c: CharmmCoeffs, eflag: bool, vflag: bool, rows):
    """Plain PyTorch version of the owned-rows kernel: (f, evdwl, ecoul,
    virial) of the rows' live entries within the cutoff
    (``list_entries``, its image rounded as the kernel's), the codes
    weighing each pair; the other slots' forces 0; with eflag = vflag =
    "atom", (f, eatom, vatom, None) per slot."""
    from tpumd_torch.ops.cellgrid_pairlist import half_virial, list_entries
    from tpumd_torch.ops.lj_cellgrid import slot_tallies
    i, j, d, r2, code = list_entries(x, box, pairs, npairs, with_codes=True,
                                     rows=rows)
    inside = r2 < max(c.cut_coulsq, c.cut_ljsq)
    i, j, d, r2, code = i[inside], j[inside], d[inside], r2[inside], \
        code[inside]
    wl, wc = special_weights(code, c, x)
    flj, evdwl, ecoul, fcoul = charmm_pair_fn(c)(
        r2, type_[i], type_[j], wl, wc, q[i], q[j])
    fp = flj + fcoul
    f = torch.zeros_like(x).index_add_(0, i, d * fp[:, None])
    if peratom_flags(eflag, vflag):
        return (f,) + slot_tallies(i, evdwl + ecoul, fp, d, x.shape[0]) \
            + (None,)
    return (f, 0.5 * torch.sum(evdwl) if eflag else None,
            0.5 * torch.sum(ecoul) if eflag else None,
            half_virial(fp, d) if vflag else None)


def charmm_pairlist_plain(x, q, type_, pairs, npairs, box: Box,
                          c: CharmmCoeffs, eflag: bool, vflag: bool,
                          rows=None):
    """Plain PyTorch version of the kernel: (f, evdwl, ecoul, virial) of
    the list's entries through ``pair_sums``, the codes weighing each
    pair.  Rows in blocks of at most 2^20 entries on the CPU (memory),
    2^24 on a card, over the columns up to the longest row, each row's
    tail past npairs taken as its own slot (the self-mask of
    ``pair_sums``).  rows, where given, the owned-rows variant's
    (``charmm_rows_plain``)."""
    if rows is not None:
        return charmm_rows_plain(x, q, type_, pairs, npairs, box, c, eflag,
                                 vflag, rows)
    n = x.shape[0]
    kk = max(int(npairs.max()), 1)
    j, code = unpack(pairs[:, :kk])
    tail = (torch.arange(kk, device=x.device)[None, :]
            >= npairs[:, None].long())
    j = torch.where(tail, torch.arange(n, dtype=j.dtype,
                                       device=x.device)[:, None], j)
    code = torch.where(tail, 0, code)
    rows = max(1, (1 << (20 if x.device.type == "cpu" else 24)) // kk)
    f = torch.empty_like(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    evdwl, ecoul, virial = zero, zero, torch.zeros(6, dtype=x.dtype,
                                                   device=x.device)
    pair_fn = charmm_pair_fn(c)
    if peratom_flags(eflag, vflag):
        eatom = torch.empty(n, dtype=x.dtype, device=x.device)
        vatom = torch.empty((n, 6), dtype=x.dtype, device=x.device)
    for b0 in range(0, n, rows):
        b1 = min(b0 + rows, n)
        fb, ev, ec, vir = pair_sums(
            x[b0:b1], type_[b0:b1], box, j[b0:b1], code[b0:b1], None,
            c.w_lj, c.w_coul, eflag, vflag, q=q[b0:b1], pair_fn_ex=pair_fn,
            ext=(x, type_, q, box), row0=b0)
        f[b0:b1] = fb
        if eflag == "atom":
            eatom[b0:b1], vatom[b0:b1] = ev, ec
            continue
        if eflag:
            evdwl, ecoul = evdwl + ev, ecoul + ec
        if vflag:
            virial = virial + vir
    if eflag == "atom":
        return f, eatom, vatom, None
    return (f, evdwl if eflag else None, ecoul if eflag else None,
            virial if vflag else None)


_FN_NAMES = {torch.float32: "tpumd_charmm_pairlist_f32",
             torch.float64: "tpumd_charmm_pairlist_f64"}
_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_ARGTYPES = ([_P] * 5 + [_I, _L, _P, _L] + [_P] * 2 + [_I] + [_P] * 4
             + [_D] * 6 + [_D] * 8 + [_I, _I, _P])


def _check(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"charmm_cellgrid: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def charmm_cellgrid(x, q, type_, pairs, npairs, box: Box,
                    cfg: CellGridConfig, c: CharmmCoeffs, eflag: bool,
                    vflag: bool, rows=None):
    """Forces (Np, 3), evdwl and ecoul () or None and virial (6,) or None
    of lj/charmm/coul/long over the grid's pair list (pairs (Np, K),
    npairs (Np,), ops/cellgrid_pairlist.py); energies and virial take 1/2
    per ordered pair.  With eflag = vflag = "atom": (f, eatom (Np,) the
    lj + coul energy, vatom (Np, 6), None), each slot's half share.
    rows (n,) int64, where given, the slots whose rows are swept (B5-rows:
    a rank's owned atoms); the others' forces are 0.  Raises without a
    list."""
    if pairs is None or npairs is None:
        raise ValueError("charmm_cellgrid: no pair list; the grid state "
                         "of a style that sweeps one carries it from its "
                         "last re-bin")
    np_ = cfg.capacity
    if (pairs.dim() != 2 or pairs.shape[0] != np_
            or tuple(npairs.shape) != (np_,)):
        raise ValueError(f"charmm_cellgrid: a ({np_}, K) list and ({np_},) "
                         f"counts expected, got {tuple(pairs.shape)} and "
                         f"{tuple(npairs.shape)}")
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 1
                             or rows.shape[0] > np_):
        raise ValueError(f"charmm_cellgrid: rows must be a (n <= {np_},) "
                         f"int64 tensor, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return charmm_pairlist_plain(x, q, type_, pairs, npairs, box, c,
                                     eflag, vflag, rows)
    if x.device.type != "cuda":
        raise ValueError(f"charmm_cellgrid: no kernel for device {x.device}")
    out = launch(_build.kernel_function(_FN_NAMES[_dtype(x)], _ARGTYPES),
                 x, q, type_, pairs, npairs, box, cfg, c, eflag, vflag, rows)
    if rows is None or rows.shape[0]:
        counts.kernel_launches += 1
        counts.rows_launches += rows is not None
        counts.peratom_launches += eflag == "atom"
    return out


def _dtype(x):
    if x.dtype not in _FN_NAMES:
        raise TypeError(f"charmm_cellgrid: x must be float32 or float64, "
                        f"got {x.dtype}")
    return x.dtype


def launch(fn, x, q, type_, pairs, npairs, box: Box, cfg: CellGridConfig,
           c: CharmmCoeffs, eflag: bool, vflag: bool, rows=None):
    """Check the CUDA inputs and launch the library function fn (the
    kernel of x's dtype, bound with _ARGTYPES); the outputs of
    charmm_cellgrid.  With rows the outputs start at zero (the slots
    that are not swept keep it), and no row launches nothing."""
    if not all(box.periodic):
        raise NotImplementedError(
            f"charmm_cellgrid: the kernel takes a periodic box only, got "
            f"periodic flags {box.periodic}")
    peratom = peratom_flags(eflag, vflag)
    eflag, vflag = bool(eflag), bool(vflag)
    np_, K = cfg.capacity, pairs.shape[-1]
    nt1 = c.lj.shape[-1]
    _check("x", x, _dtype(x), (np_, 3), x.device)
    _check("q", q, x.dtype, (np_,), x.device)
    _check("type", type_, torch.int32, (np_,), x.device)
    _check("pairs", pairs, torch.int32, (np_, K), x.device)
    _check("npairs", npairs, torch.int32, (np_,), x.device)
    _check("box lengths", box.lengths, x.dtype, (3,), x.device)
    _check("lj tables", c.lj, x.dtype, (4, nt1, nt1), x.device)
    if rows is not None:
        _check("rows", rows, torch.int64, (rows.shape[0],), x.device)
    new = torch.empty if rows is None else torch.zeros
    f = new(x.shape, dtype=x.dtype, device=x.device)
    # per-slot van der Waals (row 0) and Coulomb (row 1) energies
    eslot = (new((2, np_), dtype=x.dtype, device=x.device)
             if eflag else None)
    vslot = (new((np_, 6), dtype=x.dtype, device=x.device)
             if vflag else None)
    rc = 0
    if rows is None or rows.shape[0]:
        rc = _launch(fn, x, q, type_, pairs, npairs, K, np_, rows, box, c,
                     nt1, f, eslot, vslot, eflag, vflag)
    if rc != 0:
        raise RuntimeError(f"charmm_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    if peratom:
        return f, 0.5 * (eslot[0] + eslot[1]), 0.5 * vslot, None
    evdwl = ecoul = virial = None
    if eflag:
        evdwl, ecoul = 0.5 * torch.sum(eslot, dim=1)
    if vflag:
        virial = 0.5 * torch.sum(vslot, dim=0)
    return f, evdwl, ecoul, virial


def _launch(fn, x, q, type_, pairs, npairs, K, np_, rows, box, c, nt1, f,
            eslot, vslot, eflag, vflag) -> int:
    """The library call of launch: its CUDA error code."""
    with torch.cuda.device(x.device):
        return fn(x.data_ptr(), q.data_ptr(), type_.data_ptr(),
                  pairs.data_ptr(), npairs.data_ptr(), K, np_,
                  None if rows is None else rows.data_ptr(),
                  0 if rows is None else rows.shape[0],
                  box.lengths.data_ptr(), c.lj.data_ptr(), nt1, f.data_ptr(),
                  None if eslot is None else eslot[0].data_ptr(),
                  None if eslot is None else eslot[1].data_ptr(),
                  None if vslot is None else vslot.data_ptr(),
                  c.qqrd2e, c.g_ewald, c.cut_coulsq, c.cut_ljsq,
                  c.cut_lj_innersq, c.denom_lj, *c.w_lj, *c.w_coul,
                  int(bool(eflag)), int(bool(vflag)),
                  torch.cuda.current_stream(x.device).cuda_stream)
