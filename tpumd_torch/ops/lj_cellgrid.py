"""Single-type lj/cut on the cell grid: the CUDA kernel, its wrapper and
its plain PyTorch version.

The kernel (``tpumd_torch/csrc/lj_cellgrid.cu``) replaces the TPU kernel
tpumd/ops/pallas_lj.py::_kernel and also writes per-slot energy and
virial, so thermo steps need no second sweep.  ``lj_cellgrid`` launches it
for CUDA tensors and takes the plain version only for CPU tensors; it
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, cellgrid_pair_sums


class LJCoeffs(NamedTuple):
    """Scalar lj/cut coefficients (LAMMPS convention, pair_lj_cut.cpp)."""
    lj1: float      # 48 eps sig^12
    lj2: float      # 24 eps sig^6
    lj3: float      # 4 eps sig^12
    lj4: float      # 4 eps sig^6
    offset: float   # energy shift at the cutoff (pair_modify shift)
    cutsq: float


class LaunchCounts:
    """How often the wrapper launched the kernel or ran the plain version."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.kernel_launches = 0
        self.plain_calls = 0


counts = LaunchCounts()


def lj_pair_fn(c: LJCoeffs):
    """(fpair, evdwl) of single-type lj/cut, as
    tpumd/models/pair_lj_cut.py::pair_fn computes it for one type."""

    def pair_fn(r2, itype, jtype):
        inside = r2 < c.cutsq
        r2inv = inside.to(r2.dtype) / torch.where(inside, r2, 1.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = r6inv * (c.lj1 * r6inv - c.lj2) * r2inv
        evdwl = torch.where(inside, r6inv * (c.lj3 * r6inv - c.lj4)
                            - c.offset, 0.0)
        return fpair, evdwl

    return pair_fn


def lj_cellgrid_plain(x, valid, box: Box, cfg: CellGridConfig, c: LJCoeffs,
                      eflag: bool, vflag: bool):
    """Plain PyTorch version of the kernel: (f, evdwl, virial)."""
    return cellgrid_pair_sums(x, None, valid, box, cfg, lj_pair_fn(c),
                              eflag, vflag)


_FN_NAMES = {torch.float32: "tpumd_lj_cellgrid_f32",
             torch.float64: "tpumd_lj_cellgrid_f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_D] * 6 + [_I, _I, _P]


def check_grid_inputs(x, valid, box: Box, cfg: CellGridConfig,
                      name="lj_cellgrid", periodic_only=True):
    """Raise on inputs a cell-grid kernel does not take; unless
    periodic_only is False, that includes a box with a non-periodic axis
    (the kernel adds the wrap correction on every axis)."""
    if periodic_only and not all(box.periodic):
        raise NotImplementedError(
            f"{name}: the kernel takes a periodic box only, got periodic "
            f"flags {box.periodic}")
    if x.dtype not in _FN_NAMES:
        raise TypeError(f"{name}: x must be float32 or float64, "
                        f"got {x.dtype}")
    if tuple(x.shape) != (cfg.capacity, 3) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous "
                         f"({cfg.capacity}, 3) tensor, got {tuple(x.shape)}")
    if (valid.dtype != torch.bool or tuple(valid.shape) != (cfg.capacity,)
            or not valid.is_contiguous()):
        raise ValueError(f"{name}: valid must be a contiguous bool "
                         f"({cfg.capacity},) tensor")
    lengths = box.lengths
    if lengths.dtype != x.dtype or not lengths.is_contiguous():
        raise ValueError(f"{name}: box lengths must be contiguous and "
                         "of x's dtype")
    for what, t in (("valid", valid), ("box", lengths)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, "
                             f"x on {x.device}")
    if not 1 <= cfg.cap <= 1024:
        raise ValueError(f"{name}: cap {cfg.cap} outside 1..1024")


def lj_cellgrid(x, valid, box: Box, cfg: CellGridConfig, c: LJCoeffs,
                eflag: bool, vflag: bool):
    """Forces (Np, 3), evdwl () or None and virial (6,) or None of
    single-type lj/cut on the cell grid; energy and virial take 1/2 per
    ordered pair (tpumd/ops/cellgrid.py:523-532)."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return lj_cellgrid_plain(x, valid, box, cfg, c, eflag, vflag)
    if x.device.type != "cuda":
        raise ValueError(f"lj_cellgrid: no kernel for device {x.device}")
    check_grid_inputs(x, valid, box, cfg)
    fn = _build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES)
    f = torch.empty_like(x)
    eslot = (torch.empty(cfg.capacity, dtype=x.dtype, device=x.device)
             if eflag else None)
    vslot = (torch.empty((cfg.capacity, 6), dtype=x.dtype, device=x.device)
             if vflag else None)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), valid.data_ptr(), box.lengths.data_ptr(),
                f.data_ptr(),
                None if eslot is None else eslot.data_ptr(),
                None if vslot is None else vslot.data_ptr(),
                cfg.nx, cfg.ny, cfg.nz, cfg.cap, *c, int(eflag), int(vflag),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lj_cellgrid kernel launch failed: CUDA error "
                           f"{rc}")
    counts.kernel_launches += 1
    evdwl = 0.5 * torch.sum(eslot) if eflag else None
    virial = 0.5 * torch.sum(vslot, dim=0) if vflag else None
    return f, evdwl, virial
