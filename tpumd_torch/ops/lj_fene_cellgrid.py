"""Single-type lj/cut plus FENE bonds on the cell grid: the CUDA kernel,
its wrapper and its plain PyTorch versions.

The kernel (``tpumd_torch/csrc/lj_fene_cellgrid.cu``) replaces the TPU
kernel tpumd/ops/pallas_lj.py::_kernel_fene, which matched each
candidate's tag against the i slot's bond-partner tags, a bonded pair
taking only the FENE force (special_bonds fene).  It sweeps the grid's
pair list (``ops/cellgrid_pairlist.py``, built at every re-bin with the
bond partners coded 1): lj/cut over the code-0 entries, and the FENE +
WCA term over each slot's partner slots (``bond_slots``, mapped from the
partner tags at the same re-bin), whatever their distance.  It also
writes per-slot lj and bond energies and the virial, so thermo steps need
no second sweep.  ``lj_fene_cellgrid`` launches it for CUDA tensors and
takes the plain list sweep (``lj_fene_pairlist_plain``) only for CPU
tensors; it never falls back from one to the other.
``lj_fene_cellgrid_plain``, the sweep over the 27-cell stencil that
matches partner tags pair by pair, is the oracle the list sweep is held
to; no run calls it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, cellgrid_pair_sums
from tpumd_torch.ops.cellgrid_pairlist import half_virial, image_shift, \
    list_entries
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, LJCoeffs, \
    check_grid_inputs, check_list, lj_pair_fn, peratom_flags, slot_tallies


class FENECoeffs(NamedTuple):
    """Scalar coefficients of one FENE bond type (bond_fene.cpp)."""
    k: float
    r0sq: float     # R0^2
    epsilon: float
    sig2: float     # sigma^2


counts = LaunchCounts()

# (2^(1/6) sigma)^2 / sigma^2: the WCA part acts below this r^2 / sigma^2
WCA_R2 = 2.0 ** (1.0 / 3.0)


def fene_wca(r2, k, r0sq, eps, sig2):
    """(fbond, ebond) of FENE + WCA per pair (bond_fene.cpp:53-120):
    1 - r^2/R0^2 is clamped at 0.1, as both the reference and tpumd do."""
    rlogarg = torch.clamp(1.0 - r2 / r0sq, min=0.1)
    fbond = -k / rlogarg
    ebond = -0.5 * k * r0sq * torch.log(rlogarg)
    sr2 = sig2 / r2
    sr6 = sr2 * sr2 * sr2
    inside = r2 < WCA_R2 * sig2
    fbond = fbond + torch.where(inside, 48.0 * eps * sr6 * (sr6 - 0.5) / r2,
                                0.0)
    ebond = ebond + torch.where(inside, 4.0 * eps * sr6 * (sr6 - 1.0) + eps,
                                0.0)
    return fbond, ebond


def lj_fene_cellgrid_plain(x, valid, tag, bond_tags, box: Box,
                           cfg: CellGridConfig, lj: LJCoeffs,
                           fene: FENECoeffs, eflag: bool, vflag: bool):
    """The stencil oracle: (f, evdwl, virial, ebond) summed over the
    27-cell stencil, bond partners matched by tag."""
    def bond_fn(r2, btype):
        return fene_wca(r2, *fene)
    bond = (bond_tags, torch.ones_like(bond_tags), bond_fn, tag)
    return cellgrid_pair_sums(x, None, valid, box, cfg, lj_pair_fn(lj),
                              eflag, vflag, bond=bond)


def _image_d(x, i, j, box: Box):
    """(n, 3) x_i - (x_j + image_shift), as the kernel rounds it."""
    return x[i] - (x[j] + image_shift(x[i] - x[j], box))


def lj_fene_pairlist_plain(x, box: Box, lj: LJCoeffs, fene: FENECoeffs,
                           eflag: bool, vflag: bool, pairs, npairs,
                           bond_slots):
    """Plain PyTorch version of the kernel: (f, evdwl, virial, ebond) of
    lj/cut over the list's code-0 entries within the cutoff and FENE + WCA
    over each slot's partner slots (bond_slots (Np, nb), -1: none)."""
    ii, _, d, r2 = list_entries(x, box, pairs, npairs)
    inside = r2 < lj.cutsq
    ii, d, r2 = ii[inside], d[inside], r2[inside]
    fp, e = lj_pair_fn(lj)(r2, None, None)
    bi, bcol = torch.nonzero(bond_slots >= 0, as_tuple=True)
    bd = _image_d(x, bi, bond_slots[bi, bcol].long(), box)
    br2 = bd[:, 0] * bd[:, 0] + bd[:, 1] * bd[:, 1] + bd[:, 2] * bd[:, 2]
    bf, be = fene_wca(br2, *fene)
    ii, d, fp = torch.cat([ii, bi]), torch.cat([d, bd]), torch.cat([fp, bf])
    f = torch.zeros_like(x).index_add_(0, ii, d * fp[:, None])
    if peratom_flags(eflag, vflag):
        return (f,) + slot_tallies(ii, torch.cat([e, be]), fp, d,
                                   x.shape[0]) + (None,)
    evdwl = ebond = virial = None
    if eflag:
        evdwl, ebond = 0.5 * torch.sum(e), 0.5 * torch.sum(be)
    if vflag:
        virial = half_virial(fp, d)
    return f, evdwl, virial, ebond


_FN_NAMES = {torch.float32: "tpumd_lj_fene_cellgrid_f32",
             torch.float64: "tpumd_lj_fene_cellgrid_f64"}
_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_ARGTYPES = [_P] * 11 + [_L, _L, _I, _I] + [_D] * 10 + [_I, _I, _P]


def _check(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"lj_fene_cellgrid: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def lj_fene_cellgrid(x, valid, box: Box, cfg: CellGridConfig, lj: LJCoeffs,
                     fene: FENECoeffs, eflag: bool, vflag: bool, plist):
    """Forces (Np, 3), evdwl () or None, virial (6,) or None and ebond ()
    or None of single-type lj/cut plus one FENE bond type over the grid's
    pair list plist = (pairs (Np, K), npairs (Np,), bond_slots (Np, nb),
    rows (natoms,) the valid slots, the grid state's row2slot); energies
    and virial take 1/2 per ordered pair.  With eflag = vflag = "atom"
    the energy (lj + bond) and virial are per slot, each slot's half share,
    and ebond is None.  Raises without a list."""
    check_list("lj_fene_cellgrid", plist, cfg.capacity, x.device)
    pairs, npairs, bond_slots, rows = plist
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return lj_fene_pairlist_plain(x, box, lj, fene, eflag, vflag, pairs,
                                      npairs, bond_slots)
    if x.device.type != "cuda":
        raise ValueError(f"lj_fene_cellgrid: no kernel for device "
                         f"{x.device}")
    out = launch(_build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES), x,
                 valid, box, cfg, lj, fene, eflag, vflag, plist)
    counts.kernel_launches += 1
    counts.peratom_launches += eflag == "atom"
    return out


def launch(fn, x, valid, box: Box, cfg: CellGridConfig, lj: LJCoeffs,
           fene: FENECoeffs, eflag: bool, vflag: bool, plist):
    """Check the CUDA inputs and launch the library function fn (the
    kernel of x's dtype, bound with _ARGTYPES); the outputs of
    lj_fene_cellgrid."""
    check_grid_inputs(x, valid, box, cfg, "lj_fene_cellgrid")
    peratom = peratom_flags(eflag, vflag)
    eflag, vflag = bool(eflag), bool(vflag)
    pairs, npairs, bond_slots, rows = plist
    np_, dev = cfg.capacity, x.device
    if bond_slots.dim() != 2 or not 1 <= bond_slots.shape[1] <= 2:
        raise ValueError(f"lj_fene_cellgrid: bond_slots must be ({np_}, 1 "
                         f"or 2), got {tuple(bond_slots.shape)}")
    _check("bond_slots", bond_slots, torch.int32,
           (np_, bond_slots.shape[1]), dev)
    f = torch.empty_like(x)
    # per-slot lj (row 0) and bond (row 1) energies
    eslot = (torch.empty((2, np_), dtype=x.dtype, device=dev)
             if eflag else None)
    vslot = (torch.empty((np_, 6), dtype=x.dtype, device=dev)
             if vflag else None)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), valid.data_ptr(), pairs.data_ptr(),
                npairs.data_ptr(), bond_slots.data_ptr(), rows.data_ptr(),
                box.lengths.data_ptr(), f.data_ptr(),
                None if eslot is None else eslot[0].data_ptr(),
                None if eslot is None else eslot[1].data_ptr(),
                None if vslot is None else vslot.data_ptr(), np_,
                rows.shape[0], pairs.shape[1], bond_slots.shape[1], *lj,
                *fene, int(eflag), int(vflag),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lj_fene_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    if peratom:
        return f, 0.5 * (eslot[0] + eslot[1]), 0.5 * vslot, None
    evdwl = ebond = virial = None
    if eflag:
        evdwl, ebond = 0.5 * torch.sum(eslot, dim=1)
    if vflag:
        virial = 0.5 * torch.sum(vslot, dim=0)
    return f, evdwl, virial, ebond
