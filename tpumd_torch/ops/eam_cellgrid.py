"""Single-element EAM on the cell grid: the two CUDA kernels, their
wrappers and their plain PyTorch versions.

The kernels (``tpumd_torch/csrc/eam_cellgrid.cu``) replace the TPU kernels
tpumd/ops/pallas_eam.py::_rho_kernel and ::_force_kernel, and read the
exact spline tables where those used Chebyshev fits.  Both sweep the
grid's pair list (``ops/cellgrid_pairlist.py``, built at every re-bin and
refreshed where the schedule could leave it stale, so it holds the
stencil's pairs):

* ``eam_rho_cellgrid``: host densities rho_i = sum_j rho(r_ij), then per
  slot the embedding derivative F'(rho_i) and, with eflag, F(rho_i) plus
  the linear term above rhomax (no elementwise pass between the
  kernels);
* ``eam_force_cellgrid``: f_i = sum_j -((F'_i + F'_j) rho'(r) + phi'(r))
  d_ij / r, with per-slot phi and virial under the flags, so thermo steps
  need no second sweep.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (``eam_rho_pairlist_plain``, ``eam_force_pairlist_plain``) only
for CPU tensors; it never falls back from one to the other.
``eam_rho_cellgrid_plain`` and ``eam_force_cellgrid_plain``, the sweeps
over the 27-cell stencil, are the oracles the list sweeps are held to; no
run calls them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, cellgrid_pair_sums, \
    stencil_blocks
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, check_grid_inputs, \
    check_list


class EAMTables(NamedTuple):
    """Exact spline tables of one element (PairEAM::interpolate): (n+1, 7)
    rows, columns 0-2 the derivative's and 3-6 the value's coefficients."""
    frho: torch.Tensor     # (nrho+1, 7) embedding F(rho)
    rhor: torch.Tensor     # (nr+1, 7) density rho(r)
    z2r: torch.Tensor      # (nr+1, 7) r phi(r)
    dr: float
    drho: float
    nr: int
    nrho: int
    rhomax: float
    cutsq: float


rho_counts = LaunchCounts()
force_counts = LaunchCounts()


def _index(v, delta: float, n: int):
    """Spline row and fraction of v (tpumd pair_eam.py _r_index and
    _rho_index): p = v / delta + 1, m = int(p) in [1, n-1], p - m <= 1."""
    p = v * (1.0 / delta) + 1.0
    m = torch.clamp(p.to(torch.int64), 1, n - 1)
    return m, torch.clamp(p - m, max=1.0)


def _value(c, p):
    return ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p + c[..., 6]


def _derivative(c, p):
    return (c[..., 0] * p + c[..., 1]) * p + c[..., 2]


def embedding(rho, valid, tab: EAMTables, eflag: bool):
    """(F'(rho) per slot, 0 in empty slots; the summed F(rho) of the valid
    slots, None unless eflag), F extended linearly above rhomax
    (tpumd pair_eam.py:311-326)."""
    m, p = _index(rho, tab.drho, tab.nrho)
    c = tab.frho[m]
    fp = torch.where(valid, _derivative(c, p), 0.0)
    if not eflag:
        return fp, None
    fval = _value(c, p) + torch.where(rho > tab.rhomax,
                                      fp * (rho - tab.rhomax), 0.0)
    return fp, torch.sum(torch.where(valid, fval, 0.0))


def eam_rho_cellgrid_plain(x, valid, box: Box, cfg: CellGridConfig,
                           tab: EAMTables, eflag: bool):
    """The stencil oracle of the density pass: (rho, fp, e_embed) summed
    over the 27-cell stencil."""
    rho = torch.zeros((cfg.nz, cfg.ny, cfg.nx, cfg.cap), dtype=x.dtype,
                      device=x.device)
    for _, _, r2, mask, _ in stencil_blocks(x, valid, box, cfg):
        inside = mask & (r2 < tab.cutsq)
        m, p = _index(torch.sqrt(r2), tab.dr, tab.nr)
        rho = rho + torch.sum(torch.where(inside, _value(tab.rhor[m], p),
                                          0.0), dim=-1)
    rho = rho.reshape(-1)
    return (rho,) + embedding(rho, valid, tab, eflag)


def eam_rho_pairlist_plain(x, valid, box: Box, tab: EAMTables, eflag: bool,
                           pairs, npairs):
    """Plain PyTorch version of the density kernel: (rho, fp, e_embed)
    over the list's entries within the cutoff."""
    from tpumd_torch.ops.cellgrid_pairlist import list_entries
    i, _, _, r2 = list_entries(x, box, pairs, npairs)
    inside = r2 < tab.cutsq
    m, p = _index(torch.sqrt(r2[inside]), tab.dr, tab.nr)
    rho = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device).index_add_(
        0, i[inside], _value(tab.rhor[m], p))
    return (rho,) + embedding(rho, valid, tab, eflag)


def eam_pair_fn(tab: EAMTables):
    """(fpair, phi) of one element given F' of both atoms, as
    tpumd/models/pair_eam.py:332-345 computes them; 0 beyond the cutoff."""

    def pair_fn(r2, fpi, fpj):
        inside = r2 < tab.cutsq
        r = torch.sqrt(r2)
        m, p = _index(r, tab.dr, tab.nr)
        cz = tab.z2r[m]
        recip = 1.0 / r
        phi = _value(cz, p) * recip
        phip = _derivative(cz, p) * recip - phi * recip
        psip = (fpi + fpj) * _derivative(tab.rhor[m], p) + phip
        return (torch.where(inside, -psip * recip, 0.0),
                torch.where(inside, phi, 0.0))

    return pair_fn


def eam_force_cellgrid_plain(x, valid, fp, box: Box, cfg: CellGridConfig,
                             tab: EAMTables, eflag: bool, vflag: bool):
    """The stencil oracle of the force pass: (f, e_pair, virial) summed
    over the 27-cell stencil."""
    return cellgrid_pair_sums(x, fp, valid, box, cfg, eam_pair_fn(tab),
                              eflag, vflag)


def eam_force_pairlist_plain(x, fp, box: Box, tab: EAMTables, eflag: bool,
                             vflag: bool, pairs, npairs):
    """Plain PyTorch version of the force kernel: (f, e_pair, virial) over
    the list's entries within the cutoff."""
    from tpumd_torch.ops.cellgrid_pairlist import half_virial, list_entries
    i, j, d, r2 = list_entries(x, box, pairs, npairs)
    inside = r2 < tab.cutsq
    i, j, d, r2 = i[inside], j[inside], d[inside], r2[inside]
    fpair, phi = eam_pair_fn(tab)(r2, fp[i], fp[j])
    f = torch.zeros_like(x).index_add_(0, i, d * fpair[:, None])
    return (f, 0.5 * torch.sum(phi) if eflag else None,
            half_virial(fpair, d) if vflag else None)


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_RHO_FN = {torch.float32: "tpumd_eam_rho_cellgrid_f32",
           torch.float64: "tpumd_eam_rho_cellgrid_f64"}
_RHO_ARGTYPES = ([_P] * 11 + [ctypes.c_longlong] * 2 + [_I] * 3 + [_D] * 4
                 + [_I, _P])
_FORCE_FN = {torch.float32: "tpumd_eam_force_cellgrid_f32",
             torch.float64: "tpumd_eam_force_cellgrid_f64"}
_FORCE_ARGTYPES = ([_P] * 12 + [ctypes.c_longlong] * 2 + [_I, _I]
                   + [_D] * 2 + [_I, _I, _P])


def _check_tables(x, tab: EAMTables, name: str):
    for what, t, n in (("frho", tab.frho, tab.nrho), ("rhor", tab.rhor, tab.nr),
                       ("z2r", tab.z2r, tab.nr)):
        if (t.dtype != x.dtype or t.device != x.device
                or tuple(t.shape) != (n + 1, 7) or not t.is_contiguous()):
            raise ValueError(f"{name}: table {what} must be a contiguous "
                             f"({n + 1}, 7) tensor of x's dtype on "
                             f"{x.device}")
    if tab.nr < 2 or tab.nrho < 2:
        raise ValueError(f"{name}: tables of nr {tab.nr}, nrho {tab.nrho}")


def _slot_vector(x, cfg):
    return torch.empty(cfg.capacity, dtype=x.dtype, device=x.device)


def eam_rho_cellgrid(x, valid, box: Box, cfg: CellGridConfig,
                     tab: EAMTables, eflag: bool, plist):
    """Host density rho (Np,), embedding derivative fp (Np,; 0 in empty
    slots) and, with eflag, the embedding energy () of the valid slots
    (else None), over the grid's pair list plist = (pairs (Np, K), npairs
    (Np,), rows (natoms,) the valid slots, the grid state's row2slot).
    Raises without a list."""
    check_list("eam_rho_cellgrid", plist, cfg.capacity, x.device)
    pairs, npairs, rows = plist
    if x.device.type == "cpu":
        rho_counts.plain_calls += 1
        return eam_rho_pairlist_plain(x, valid, box, tab, eflag, pairs,
                                      npairs)
    if x.device.type != "cuda":
        raise ValueError(f"eam_rho_cellgrid: no kernel for device "
                         f"{x.device}")
    out = launch_rho(_build.kernel_function(_RHO_FN[x.dtype],
                                            _RHO_ARGTYPES),
                     x, valid, box, cfg, tab, eflag, plist)
    rho_counts.kernel_launches += 1
    return out


def launch_rho(fn, x, valid, box: Box, cfg: CellGridConfig, tab: EAMTables,
               eflag: bool, plist):
    """Check the CUDA inputs and launch the library function fn (the
    density kernel of x's dtype, bound with _RHO_ARGTYPES); the outputs of
    eam_rho_cellgrid."""
    check_grid_inputs(x, valid, box, cfg, "eam_rho_cellgrid")
    _check_tables(x, tab, "eam_rho_cellgrid")
    pairs, npairs, rows = plist
    rho, fp = _slot_vector(x, cfg), _slot_vector(x, cfg)
    eslot = _slot_vector(x, cfg) if eflag else None
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), valid.data_ptr(), pairs.data_ptr(),
                npairs.data_ptr(), rows.data_ptr(), box.lengths.data_ptr(),
                tab.rhor.data_ptr(), tab.frho.data_ptr(), rho.data_ptr(),
                fp.data_ptr(), None if eslot is None else eslot.data_ptr(),
                cfg.capacity, rows.shape[0], pairs.shape[1], tab.nr,
                tab.nrho, 1.0 / tab.dr, 1.0 / tab.drho, tab.rhomax,
                tab.cutsq, int(eflag),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eam_rho_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    return rho, fp, (torch.sum(eslot) if eflag else None)


def eam_force_cellgrid(x, valid, fp, box: Box, cfg: CellGridConfig,
                       tab: EAMTables, eflag: bool, vflag: bool, plist):
    """Forces (Np, 3), pair energy () or None and virial (6,) or None of
    one EAM element over the grid's pair list plist = (pairs (Np, K),
    npairs (Np,), rows (natoms,) the valid slots, the grid state's
    row2slot), given the embedding derivative fp of every slot; the pair
    energy and virial take 1/2 per ordered pair.  Raises without a
    list."""
    check_list("eam_force_cellgrid", plist, cfg.capacity, x.device)
    pairs, npairs, rows = plist
    if x.device.type == "cpu":
        force_counts.plain_calls += 1
        return eam_force_pairlist_plain(x, fp, box, tab, eflag, vflag, pairs,
                                        npairs)
    if x.device.type != "cuda":
        raise ValueError(f"eam_force_cellgrid: no kernel for device "
                         f"{x.device}")
    out = launch_force(_build.kernel_function(_FORCE_FN[x.dtype],
                                              _FORCE_ARGTYPES),
                       x, valid, fp, box, cfg, tab, eflag, vflag, plist)
    force_counts.kernel_launches += 1
    return out


def launch_force(fn, x, valid, fp, box: Box, cfg: CellGridConfig,
                 tab: EAMTables, eflag: bool, vflag: bool, plist):
    """Check the CUDA inputs and launch the library function fn (the force
    kernel of x's dtype, bound with _FORCE_ARGTYPES); the outputs of
    eam_force_cellgrid."""
    check_grid_inputs(x, valid, box, cfg, "eam_force_cellgrid")
    _check_tables(x, tab, "eam_force_cellgrid")
    if (fp.dtype != x.dtype or tuple(fp.shape) != (cfg.capacity,)
            or not fp.is_contiguous() or fp.device != x.device):
        raise ValueError(f"eam_force_cellgrid: fp must be a contiguous "
                         f"({cfg.capacity},) tensor of x's dtype on "
                         f"{x.device}")
    pairs, npairs, rows = plist
    f = torch.empty_like(x)
    eslot = _slot_vector(x, cfg) if eflag else None
    vslot = (torch.empty((cfg.capacity, 6), dtype=x.dtype, device=x.device)
             if vflag else None)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), valid.data_ptr(), fp.data_ptr(),
                pairs.data_ptr(), npairs.data_ptr(), rows.data_ptr(),
                box.lengths.data_ptr(), tab.rhor.data_ptr(),
                tab.z2r.data_ptr(), f.data_ptr(),
                None if eslot is None else eslot.data_ptr(),
                None if vslot is None else vslot.data_ptr(), cfg.capacity,
                rows.shape[0], pairs.shape[1], tab.nr, 1.0 / tab.dr,
                tab.cutsq, int(eflag), int(vflag),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eam_force_cellgrid kernel launch failed: CUDA "
                           f"error {rc}")
    e_pair = 0.5 * torch.sum(eslot) if eflag else None
    virial = 0.5 * torch.sum(vslot, dim=0) if vflag else None
    return f, e_pair, virial
