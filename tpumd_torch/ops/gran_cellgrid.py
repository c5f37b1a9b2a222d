"""gran/hooke/history on the cell grid: the CUDA kernel, its wrapper and
its plain PyTorch version.

The kernel (``tpumd_torch/csrc/gran_cellgrid.cu``) replaces the TPU
kernel tpumd/ops/pallas_gran.py::_kernel (entry
gran_cellgrid_forces_pallas): Hookean normal contact with velocity
damping, the tangential spring of the per-contact shear history with
Coulomb friction, torques, the frozen group's effective-mass rule and the
group-pair exclusions, with the compact tag-keyed history re-compacted in
the sweep.  ``gran_cellgrid`` launches it for CUDA tensors and takes the
plain version (``ops/cellgrid_gran.py::gran_compact_sums``) only for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig
from tpumd_torch.ops.cellgrid_gran import KH, GranCoeffs, gran_compact_sums
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, check_grid_inputs

MAX_EXCLUDE = 4     # kMaxExcl of the kernel

counts = LaunchCounts()

_FN_NAMES = {torch.float32: "tpumd_gran_cellgrid_f32",
             torch.float64: "tpumd_gran_cellgrid_f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = ([_P] * 15 + [_I] * 7 + [_D] * 6 + [_I, _I, _P, _I, _I, _P])


def _check(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"gran_cellgrid: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def gran_cellgrid(x, tag, valid, shear_tags, shear, box: Box,
                  cfg: CellGridConfig, c: GranCoeffs, planes, dt: float,
                  shearupdate: bool):
    """Forces (Np, 3), torques (Np, 3) and the history tables after the
    sweep (the input tables when not shearupdate) of gran/hooke/history
    on the cell grid; arguments as ``gran_compact_sums``."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return gran_compact_sums(x, tag, valid, shear_tags, shear, box, cfg,
                                 c, planes, dt, shearupdate)
    if x.device.type != "cuda":
        raise ValueError(f"gran_cellgrid: no kernel for device {x.device}")
    check_grid_inputs(x, valid, box, cfg, "gran_cellgrid",
                      periodic_only=False)
    v, omega, radius, rmass, gmask = planes
    np_ = cfg.capacity
    dev = x.device
    _check("tag", tag, torch.int32, (np_,), dev)
    _check("shear_tags", shear_tags, torch.int32, (np_, KH), dev)
    _check("shear", shear, x.dtype, (np_, KH, 3), dev)
    _check("v", v, x.dtype, (np_, 3), dev)
    _check("omega", omega, x.dtype, (np_, 3), dev)
    _check("radius", radius, x.dtype, (np_,), dev)
    _check("rmass", rmass, x.dtype, (np_,), dev)
    if c.freeze_bit or c.exclude_bits:
        if gmask is None:
            raise ValueError("gran_cellgrid: group bits need gmask")
        _check("gmask", gmask, torch.int32, (np_,), dev)
    if len(c.exclude_bits) > MAX_EXCLUDE:
        raise NotImplementedError(f"gran_cellgrid: more than {MAX_EXCLUDE} "
                                  "neigh_modify exclude group pairs")
    excl = (ctypes.c_int * (2 * MAX_EXCLUDE))(
        *[int(b) for pair in c.exclude_bits for b in pair])
    fn = _build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES)
    f = torch.empty_like(x)
    torque = torch.empty_like(x)
    if shearupdate:
        tags_new, shear_new = torch.empty_like(shear_tags), \
            torch.empty_like(shear)
    else:
        tags_new, shear_new = shear_tags, shear
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), v.data_ptr(), omega.data_ptr(),
                radius.data_ptr(), rmass.data_ptr(),
                None if gmask is None else gmask.data_ptr(),
                valid.data_ptr(), tag.data_ptr(), shear_tags.data_ptr(),
                shear.data_ptr(), box.lengths.data_ptr(), f.data_ptr(),
                torque.data_ptr(), tags_new.data_ptr(), shear_new.data_ptr(),
                cfg.nx, cfg.ny, cfg.nz, cfg.cap, *(int(p) for p in
                                                   box.periodic),
                c.kn, c.kt, c.gamman, c.gammat, c.xmu, float(dt),
                int(c.freeze_bit), len(c.exclude_bits),
                ctypes.cast(excl, ctypes.c_void_p), int(c.limit_damping),
                int(shearupdate),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gran_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    counts.kernel_launches += 1
    return f, torque, tags_new, shear_new
