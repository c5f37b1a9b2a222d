"""gran/hooke/history and gran/hertz/history on the cell grid: the CUDA
kernel, its wrapper and its plain PyTorch versions.

The kernel (``tpumd_torch/csrc/gran_cellgrid.cu``) replaces the TPU
kernel tpumd/ops/pallas_gran.py::_kernel (entry
gran_cellgrid_forces_pallas): Hookean normal contact with velocity
damping, the tangential spring of the per-contact shear history with
Coulomb friction, torques and the frozen group's effective-mass rule,
with the compact tag-keyed history re-compacted in the sweep.  With
``GranCoeffs.hertz`` (gran/hertz/history) the kernel's HERTZ variant scales
the normal and tangential forces by polyhertz; tpumd runs that style on
the grid through its XLA sweep, the port through this kernel.  It sweeps
the grid's pair list (``ops/cellgrid_pairlist.py``, built at every re-bin
with the group-pair exclusions dropped), whose rows run in stencil order,
so the k-th contact of a row takes history entry k as in the stencil
sweep.  ``gran_cellgrid`` launches it for CUDA tensors and takes the
plain list sweep (``ops/cellgrid_gran.py::gran_pairlist_plain``) only
for CPU tensors; it never falls back from one to the other.
``gran_compact_sums``, the stencil sweep, is the oracle the list sweep
is held to; no run calls it.
"""

from __future__ import annotations

import ctypes

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig
from tpumd_torch.ops.cellgrid_gran import KH, GranCoeffs, \
    gran_compact_sums, gran_pairlist_plain  # noqa: F401 (the oracle)
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, check_grid_inputs



class GranLaunchCounts(LaunchCounts):
    """LaunchCounts, and how many of them were gran/hertz/history's
    (GranCoeffs.hertz: the kernel's HERTZ variant)."""

    def reset(self):
        super().reset()
        self.hertz_launches = 0
        self.hertz_plain_calls = 0


counts = GranLaunchCounts()

_FN_NAMES = {torch.float32: "tpumd_gran_cellgrid_f32",
             torch.float64: "tpumd_gran_cellgrid_f64"}
_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_ARGTYPES = ([_P] * 18 + [_L, _L] + [_I] * 4 + [_D] * 6 + [_I] * 4
             + [_P, _P])


def _check(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"gran_cellgrid: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def gran_cellgrid(x, tag, valid, shear_tags, shear, box: Box,
                  cfg: CellGridConfig, c: GranCoeffs, planes, dt: float,
                  shearupdate: bool, plist, over=None):
    """Forces (Np, 3), torques (Np, 3) and the history tables after the
    sweep (the input tables when not shearupdate) of gran/hooke/history
    over the grid's pair list plist = (pairs (Np, K), npairs (Np,), rows
    (natoms,) the valid slots, the grid state's row2slot), built with
    c.exclude_bits; other arguments as ``gran_compact_sums``.  With
    shearupdate, over (an int32 (1,) tensor beside x, or None) is raised
    to the contact count of any sphere with more than KH contacts, whose
    contacts past the KH-th lose their history.  Raises without a
    list."""
    if plist is None or plist[0] is None:
        raise ValueError("gran_cellgrid: no pair list; the grid state of "
                         "a style that sweeps one carries it from its "
                         "last re-bin")
    pairs, npairs, rows = plist
    np_ = cfg.capacity
    if (pairs.dim() != 2 or pairs.shape[0] != np_
            or tuple(npairs.shape) != (np_,)):
        raise ValueError(f"gran_cellgrid: a ({np_}, K) list and ({np_},) "
                         f"counts expected, got {tuple(pairs.shape)} and "
                         f"{tuple(npairs.shape)}")
    if x.device.type == "cpu":
        counts.plain_calls += 1
        counts.hertz_plain_calls += int(c.hertz)
        return gran_pairlist_plain(x, tag, shear_tags, shear, box, c,
                                   planes, dt, shearupdate, pairs, npairs,
                                   over)
    if x.device.type != "cuda":
        raise ValueError(f"gran_cellgrid: no kernel for device {x.device}")
    out = launch(_build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES), x,
                 tag, valid, shear_tags, shear, box, cfg, c, planes, dt,
                 shearupdate, plist, over)
    counts.kernel_launches += 1
    counts.hertz_launches += int(c.hertz)
    return out


def launch(fn, x, tag, valid, shear_tags, shear, box: Box,
           cfg: CellGridConfig, c: GranCoeffs, planes, dt: float,
           shearupdate: bool, plist, over=None):
    """Check the CUDA inputs and launch the library function fn (the
    kernel of x's dtype, bound with _ARGTYPES); the outputs of
    gran_cellgrid."""
    check_grid_inputs(x, valid, box, cfg, "gran_cellgrid",
                      periodic_only=False)
    v, omega, radius, rmass, gmask = planes
    pairs, npairs, rows = plist
    np_ = cfg.capacity
    dev = x.device
    _check("tag", tag, torch.int32, (np_,), dev)
    _check("shear_tags", shear_tags, torch.int32, (np_, KH), dev)
    _check("shear", shear, x.dtype, (np_, KH, 3), dev)
    _check("v", v, x.dtype, (np_, 3), dev)
    _check("omega", omega, x.dtype, (np_, 3), dev)
    _check("radius", radius, x.dtype, (np_,), dev)
    _check("rmass", rmass, x.dtype, (np_,), dev)
    _check("pairs", pairs, torch.int32, (np_, pairs.shape[1]), dev)
    _check("npairs", npairs, torch.int32, (np_,), dev)
    _check("rows", rows, torch.int64, (rows.shape[0],), dev)
    if rows.shape[0] > np_:
        raise ValueError(f"gran_cellgrid: {rows.shape[0]} rows for {np_} "
                         f"slots")
    if c.freeze_bit:
        if gmask is None:
            raise ValueError("gran_cellgrid: group bits need gmask")
        _check("gmask", gmask, torch.int32, (np_,), dev)
    if over is not None:
        _check("over", over, torch.int32, (1,), dev)
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
                gmask.data_ptr() if c.freeze_bit else None,
                valid.data_ptr(), tag.data_ptr(), shear_tags.data_ptr(),
                shear.data_ptr(), pairs.data_ptr(), npairs.data_ptr(),
                rows.data_ptr(), box.lengths.data_ptr(), f.data_ptr(),
                torque.data_ptr(), tags_new.data_ptr(), shear_new.data_ptr(),
                np_, rows.shape[0], pairs.shape[1],
                *(int(p) for p in box.periodic),
                c.kn, c.kt, c.gamman, c.gammat, c.xmu, float(dt),
                int(c.freeze_bit), int(c.limit_damping), int(shearupdate),
                int(c.hertz), over.data_ptr() if over is not None else None,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gran_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    return f, torque, tags_new, shear_new
