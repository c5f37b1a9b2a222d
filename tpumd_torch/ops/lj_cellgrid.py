"""Single-type lj/cut on the cell grid: the CUDA kernel, its wrapper and
its plain PyTorch versions.

The kernel (``tpumd_torch/csrc/lj_fene_cellgrid.cu``, the LJ+FENE list
sweep instantiated without bonds, with its own lanes per atom) replaces
the TPU kernel tpumd/ops/pallas_lj.py::_kernel, which tested the 27-cell
stencil at each call: it sweeps the grid's pair list
(``ops/cellgrid_pairlist.py``, built at every re-bin and refreshed where
the schedule could leave it stale), and also writes per-slot energy and
virial, so thermo steps need no second sweep.  ``lj_cellgrid`` launches it
for CUDA tensors and takes the plain list sweep (``lj_pairlist_plain``)
only for CPU tensors; it never falls back from one to the other.
``lj_cellgrid_plain``, the sweep over the 27-cell stencil, is the oracle
the list sweep is held to; no run calls it.

Beside per-tuple bonded styles (``special`` = the special_bonds lj
weights of codes 1-3), the kernel's special-weighted variant (B1-special,
the same source's SPECIAL instantiation) weighs each list entry of code c
by special[c - 1], as factor_lj does in pair_lj_cut.cpp; without it an
entry of code 1-3 weighs 0.  The variant replaces no TPU kernel of its
own: tpumd weighs these pairs in its XLA sweep (tpumd/ops/cellgrid.py:
326-400), where its Pallas kernel takes none.
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
        # launches of the per-atom variant (eflag = vflag = "atom") and of
        # the special-weighted variant, also counted in kernel_launches
        self.peratom_launches = 0
        self.special_launches = 0


def peratom_flags(eflag, vflag) -> bool:
    """Whether a call asks for per-slot tallies (eflag = vflag = "atom")."""
    if (eflag == "atom") != (vflag == "atom"):
        raise ValueError("per-atom tallies take eflag and vflag both "
                         "'atom'")
    return eflag == "atom"


def slot_tallies(i, e, fp, d, np_: int):
    """(eatom (np_,), vatom (np_, 6)) of list entries of slots i with
    energies e, force prefactors fp and separations d: half of each entry,
    summed per slot (the kernels' per-slot outputs, halved)."""
    eatom = torch.zeros(np_, dtype=d.dtype, device=d.device).index_add_(
        0, i, 0.5 * e)
    vatom = torch.zeros((np_, 6), dtype=d.dtype, device=d.device)
    vatom.index_add_(0, i, 0.5 * torch.stack(
        [fp * d[:, a] * d[:, b]
         for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))],
        dim=1))
    return eatom, vatom


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
                      eflag: bool, vflag: bool, special=None):
    """The stencil oracle: (f, evdwl, virial) summed over the 27-cell
    stencil; with special = (tag (Np,), special_tags (Np, S),
    special_codes (Np, S), (s1, s2, s3)) each special pair weighed by its
    code's weight, matched by tag in the sweep."""
    if special is None:
        return cellgrid_pair_sums(x, None, valid, box, cfg, lj_pair_fn(c),
                                  eflag, vflag)
    tag, stags, scodes, weights = special
    w = torch.tensor((1.0,) + tuple(weights), dtype=x.dtype,
                     device=x.device)[scodes.long()]
    pair_fn = lj_pair_fn(c)

    def weighed(r2, ti, tj, w_lj, w_coul, qi, qj):
        fp, e = pair_fn(r2, None, None)
        return fp * w_lj, e * w_lj, torch.zeros_like(e), torch.zeros_like(fp)

    f, evdwl, virial, _ = cellgrid_pair_sums(
        x, torch.ones_like(tag), valid, box, cfg, weighed, eflag, vflag,
        q=torch.zeros_like(x[:, 0]), special=(tag, stags, w, w),
        cutsq=c.cutsq)
    return f, evdwl, virial


def lj_pairlist_plain(x, box: Box, c: LJCoeffs, eflag: bool, vflag: bool,
                      pairs, npairs, special=None, rows=None):
    """Plain PyTorch version of the kernel: (f, evdwl, virial) of lj/cut
    over the list's code-0 entries within the cutoff, or with special =
    (s1, s2, s3) over every entry, code c weighed s_c; with eflag = vflag
    = "atom", (f, eatom, vatom) per slot.  rows, where given, the slots
    whose rows are summed (the kernel's rows), the others' forces 0."""
    from tpumd_torch.ops.cellgrid_pairlist import half_virial, list_entries
    if special is None:
        i, _, d, r2 = list_entries(x, box, pairs, npairs, rows=rows)
    else:
        i, _, d, r2, code = list_entries(x, box, pairs, npairs,
                                         with_codes=True, rows=rows)
    inside = r2 < c.cutsq
    i, d, r2 = i[inside], d[inside], r2[inside]
    fp, e = lj_pair_fn(c)(r2, None, None)
    if special is not None:
        w = torch.tensor((1.0,) + tuple(special), dtype=x.dtype,
                         device=x.device)[code[inside]]
        fp, e = fp * w, e * w
    f = torch.zeros_like(x).index_add_(0, i, d * fp[:, None])
    if peratom_flags(eflag, vflag):
        return (f,) + slot_tallies(i, e, fp, d, x.shape[0])
    return (f, 0.5 * torch.sum(e) if eflag else None,
            half_virial(fp, d) if vflag else None)


_FN_NAMES = {torch.float32: "tpumd_lj_cellgrid_f32",
             torch.float64: "tpumd_lj_cellgrid_f64"}
_SPECIAL_NAMES = {torch.float32: "tpumd_lj_special_cellgrid_f32",
                  torch.float64: "tpumd_lj_special_cellgrid_f64"}
_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_ARGTYPES = [_P] * 9 + [_L, _L, _I] + [_D] * 6 + [_I, _I, _P]
_SPECIAL_ARGTYPES = [_P] * 9 + [_L, _L, _I] + [_D] * 9 + [_I, _I, _P]


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


def check_list(name, plist, np_: int, device):
    """Raise on a list (pairs (Np, K) int32, npairs (Np,) int32, rows
    (natoms,) int64 the valid slots) that a list kernel does not take."""
    if plist is None or plist[0] is None:
        raise ValueError(f"{name}: no pair list; the grid state of a style "
                         "that sweeps one carries it from its last re-bin")
    pairs, npairs, rows = plist[0], plist[1], plist[-1]
    for what, t, dtype, shape in (
            ("pairs", pairs, torch.int32, (np_, pairs.shape[-1])),
            ("npairs", npairs, torch.int32, (np_,)),
            ("rows", rows, torch.int64, (rows.shape[0],))):
        if (t.dtype != dtype or t.dim() != len(shape)
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                             f"{shape} tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if rows.shape[0] > np_:
        raise ValueError(f"{name}: {rows.shape[0]} rows for {np_} slots")


def lj_cellgrid(x, valid, box: Box, cfg: CellGridConfig, c: LJCoeffs,
                eflag: bool, vflag: bool, plist, special=None):
    """Forces (Np, 3), evdwl () or None and virial (6,) or None of
    single-type lj/cut over the grid's pair list plist = (pairs (Np, K),
    npairs (Np,), rows (natoms,) the valid slots, the grid state's
    row2slot); energy and virial take 1/2 per ordered pair
    (tpumd/ops/cellgrid.py:523-532).  With eflag = vflag = "atom" the
    energy and virial are per slot, (Np,) and (Np, 6), each slot's half
    share (the per-atom tallies of compute pe/atom and stress/atom).
    special, the special_bonds lj weights of codes 1-3, selects the
    special-weighted variant.  Raises without a list."""
    check_list("lj_cellgrid", plist, cfg.capacity, x.device)
    pairs, npairs, rows = plist
    if special is not None:
        special = tuple(float(w) for w in special)
        if len(special) != 3:
            raise ValueError(f"lj_cellgrid: special takes the weights of "
                             f"codes 1-3, got {special}")
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return lj_pairlist_plain(x, box, c, eflag, vflag, pairs, npairs,
                                 special, rows)
    if x.device.type != "cuda":
        raise ValueError(f"lj_cellgrid: no kernel for device {x.device}")
    if special is None:
        fn = _build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES)
    else:
        fn = _build.kernel_function(_SPECIAL_NAMES[x.dtype],
                                    _SPECIAL_ARGTYPES)
    out = launch(fn, x, valid, box, cfg, c, eflag, vflag, plist, special)
    counts.kernel_launches += 1
    counts.peratom_launches += eflag == "atom"
    counts.special_launches += special is not None
    return out


def launch(fn, x, valid, box: Box, cfg: CellGridConfig, c: LJCoeffs,
           eflag: bool, vflag: bool, plist, special=None):
    """Check the CUDA inputs and launch the library function fn (the
    kernel of x's dtype, bound with _ARGTYPES, or with _SPECIAL_ARGTYPES
    and the three weights special); the outputs of lj_cellgrid."""
    check_grid_inputs(x, valid, box, cfg)
    peratom = peratom_flags(eflag, vflag)
    eflag, vflag = bool(eflag), bool(vflag)
    pairs, npairs, rows = plist
    np_ = cfg.capacity
    f = torch.empty_like(x)
    eslot = (torch.empty(np_, dtype=x.dtype, device=x.device)
             if eflag else None)
    vslot = (torch.empty((np_, 6), dtype=x.dtype, device=x.device)
             if vflag else None)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), valid.data_ptr(), pairs.data_ptr(),
                npairs.data_ptr(), rows.data_ptr(), box.lengths.data_ptr(),
                f.data_ptr(), None if eslot is None else eslot.data_ptr(),
                None if vslot is None else vslot.data_ptr(), np_,
                rows.shape[0], pairs.shape[1], *c, *(special or ()),
                int(eflag), int(vflag),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lj_cellgrid kernel launch failed: CUDA error "
                           f"{rc}")
    if peratom:
        return f, 0.5 * eslot, 0.5 * vslot
    evdwl = 0.5 * torch.sum(eslot) if eflag else None
    virial = 0.5 * torch.sum(vslot, dim=0) if vflag else None
    return f, evdwl, virial
