"""Single-type lj/cut plus FENE bonds on the cell grid: the CUDA kernel,
its wrapper and its plain PyTorch version.

The kernel (``tpumd_torch/csrc/lj_fene_cellgrid.cu``) replaces the TPU
kernel tpumd/ops/pallas_lj.py::_kernel_fene: each candidate's tag is
matched against the i slot's bond-partner tags, and a bonded pair takes
only the FENE force (special_bonds fene).  It also writes per-slot lj and
bond energies and the virial, so thermo steps need no second sweep.
``lj_fene_cellgrid`` launches it for CUDA tensors and takes the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, cellgrid_pair_sums
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, LJCoeffs, \
    check_grid_inputs, lj_pair_fn


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
    """Plain PyTorch version of the kernel: (f, evdwl, virial, ebond)."""
    def bond_fn(r2, btype):
        return fene_wca(r2, *fene)
    bond = (bond_tags, torch.ones_like(bond_tags), bond_fn, tag)
    return cellgrid_pair_sums(x, None, valid, box, cfg, lj_pair_fn(lj),
                              eflag, vflag, bond=bond)


_FN_NAMES = {torch.float32: "tpumd_lj_fene_cellgrid_f32",
             torch.float64: "tpumd_lj_fene_cellgrid_f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = [_P] * 4 + [_I] + [_P] * 5 + [_I] * 4 + [_D] * 10 + [_I, _I, _P]


def _check_tags(x, tag, bond_tags, cfg: CellGridConfig):
    np_ = cfg.capacity
    if (tag.dtype != torch.int32 or tuple(tag.shape) != (np_,)
            or not tag.is_contiguous() or tag.device != x.device):
        raise ValueError(f"lj_fene_cellgrid: tag must be a contiguous int32 "
                         f"({np_},) tensor on {x.device}")
    if (bond_tags.dtype != torch.int32 or bond_tags.dim() != 2
            or bond_tags.shape[0] != np_ or not 1 <= bond_tags.shape[1] <= 2
            or not bond_tags.is_contiguous()
            or bond_tags.device != x.device):
        raise ValueError(f"lj_fene_cellgrid: bond_tags must be a contiguous "
                         f"int32 ({np_}, 1 or 2) tensor on {x.device}, got "
                         f"{tuple(bond_tags.shape)}")


def lj_fene_cellgrid(x, valid, tag, bond_tags, box: Box,
                     cfg: CellGridConfig, lj: LJCoeffs, fene: FENECoeffs,
                     eflag: bool, vflag: bool):
    """Forces (Np, 3), evdwl () or None, virial (6,) or None and ebond ()
    or None of single-type lj/cut plus one FENE bond type on the cell
    grid; energies and virial take 1/2 per ordered pair."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return lj_fene_cellgrid_plain(x, valid, tag, bond_tags, box, cfg, lj,
                                      fene, eflag, vflag)
    if x.device.type != "cuda":
        raise ValueError(f"lj_fene_cellgrid: no kernel for device "
                         f"{x.device}")
    check_grid_inputs(x, valid, box, cfg, "lj_fene_cellgrid")
    _check_tags(x, tag, bond_tags, cfg)
    fn = _build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES)
    np_ = cfg.capacity
    f = torch.empty_like(x)
    # per-slot lj (row 0) and bond (row 1) energies
    eslot = (torch.empty((2, np_), dtype=x.dtype, device=x.device)
             if eflag else None)
    vslot = (torch.empty((np_, 6), dtype=x.dtype, device=x.device)
             if vflag else None)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), valid.data_ptr(), tag.data_ptr(),
                bond_tags.data_ptr(), bond_tags.shape[1],
                box.lengths.data_ptr(), f.data_ptr(),
                None if eslot is None else eslot[0].data_ptr(),
                None if eslot is None else eslot[1].data_ptr(),
                None if vslot is None else vslot.data_ptr(),
                cfg.nx, cfg.ny, cfg.nz, cfg.cap, *lj, *fene, int(eflag),
                int(vflag), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lj_fene_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    counts.kernel_launches += 1
    evdwl = ebond = virial = None
    if eflag:
        evdwl, ebond = 0.5 * torch.sum(eslot, dim=1)
    if vflag:
        virial = 0.5 * torch.sum(vslot, dim=0)
    return f, evdwl, virial, ebond
