"""lj/charmm/coul/long on the cell grid: the CUDA kernel, its wrapper and
its plain PyTorch version.

The kernel (``tpumd_torch/csrc/charmm_cellgrid.cu``) replaces the TPU
kernel tpumd/ops/pallas_charmm.py::_kernel (entry
charmm_cellgrid_forces_pallas): CHARMM-switched LJ, real-space Ewald
Coulomb through the reference's erfc polynomial, and the 1-2/1-3/1-4
special weights matched in the sweep against each i slot's special list,
with the kspace exclusion correction of excluded Coulomb pairs.  It also
writes per-slot van der Waals and Coulomb energies and the virial, so
thermo steps need no second sweep.  ``charmm_cellgrid`` launches it for
CUDA tensors and takes the plain version only for CPU tensors; it never
falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, cellgrid_pair_sums
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, check_grid_inputs

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
    """Plain PyTorch version of the kernel: (f, evdwl, ecoul, virial).
    Blocks of at most 2^22 candidates on the CPU (memory), 2^26 on a
    card."""
    wl, wc = special_weights(scodes, c, x)
    f, evdwl, virial, ecoul = cellgrid_pair_sums(
        x, type_, valid, box, cfg, charmm_pair_fn(c), eflag, vflag, q=q,
        special=(tag, stags, wl, wc),
        cutsq=max(c.cut_coulsq, c.cut_ljsq),
        max_pairs=1 << (22 if x.device.type == "cpu" else 26))
    return f, evdwl, ecoul, virial


_FN_NAMES = {torch.float32: "tpumd_charmm_cellgrid_f32",
             torch.float64: "tpumd_charmm_cellgrid_f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = ([_P] * 7 + [_I] + [_P] * 2 + [_I] + [_P] * 4 + [_I] * 4
             + [_D] * 6 + [_D] * 8 + [_I, _I, _P])


def _check(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"charmm_cellgrid: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def charmm_cellgrid(x, q, type_, valid, tag, stags, scodes, box: Box,
                    cfg: CellGridConfig, c: CharmmCoeffs, eflag: bool,
                    vflag: bool):
    """Forces (Np, 3), evdwl and ecoul () or None and virial (6,) or None
    of lj/charmm/coul/long on the cell grid, special weights matched by
    tag; energies and virial take 1/2 per ordered pair."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return charmm_cellgrid_plain(x, q, type_, valid, tag, stags, scodes,
                                     box, cfg, c, eflag, vflag)
    if x.device.type != "cuda":
        raise ValueError(f"charmm_cellgrid: no kernel for device {x.device}")
    check_grid_inputs(x, valid, box, cfg, "charmm_cellgrid")
    np_ = cfg.capacity
    nt1 = c.lj.shape[-1]
    S = stags.shape[1]
    _check("q", q, x.dtype, (np_,), x.device)
    _check("type", type_, torch.int32, (np_,), x.device)
    _check("tag", tag, torch.int32, (np_,), x.device)
    _check("special_tags", stags, torch.int32, (np_, S), x.device)
    _check("special_codes", scodes, torch.int32, (np_, S), x.device)
    _check("lj tables", c.lj, x.dtype, (4, nt1, nt1), x.device)
    fn = _build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES)
    f = torch.empty_like(x)
    # per-slot van der Waals (row 0) and Coulomb (row 1) energies
    eslot = (torch.empty((2, np_), dtype=x.dtype, device=x.device)
             if eflag else None)
    vslot = (torch.empty((np_, 6), dtype=x.dtype, device=x.device)
             if vflag else None)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), q.data_ptr(), type_.data_ptr(),
                valid.data_ptr(), tag.data_ptr(), stags.data_ptr(),
                scodes.data_ptr(), S, box.lengths.data_ptr(),
                c.lj.data_ptr(), nt1, f.data_ptr(),
                None if eslot is None else eslot[0].data_ptr(),
                None if eslot is None else eslot[1].data_ptr(),
                None if vslot is None else vslot.data_ptr(),
                cfg.nx, cfg.ny, cfg.nz, cfg.cap, c.qqrd2e, c.g_ewald,
                c.cut_coulsq, c.cut_ljsq, c.cut_lj_innersq, c.denom_lj,
                *c.w_lj, *c.w_coul, int(eflag), int(vflag),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"charmm_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    counts.kernel_launches += 1
    evdwl = ecoul = virial = None
    if eflag:
        evdwl, ecoul = 0.5 * torch.sum(eslot, dim=1)
    if vflag:
        virial = 0.5 * torch.sum(vslot, dim=0)
    return f, evdwl, ecoul, virial
