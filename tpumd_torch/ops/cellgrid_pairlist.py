"""The cell grid's pair list: the CUDA build kernel, its wrapper and its
plain PyTorch version.

A pair list holds, for every grid slot i, every valid j != i within
cutneigh of it when the grid was binned, in the order the 27-cell stencil
visits them (z, y, x offsets, then slot; a non-periodic axis drops the
offsets that alias, as ``cellgrid._offs`` does), as LAMMPS's full lists
hold them: ``pairs`` (Np, K) int32 of entries ``j | code << 30`` (SBBITS = 30,
NEIGHMASK, src/neighbor.h), code the pair's special_bonds code 0-3, and
``npairs`` (Np,) int32, each row's count.  A row is padded with its own
slot at code 0, the self-mask of ``ops/pairwise.py``.  Entries address
grid slots and carry no image shift: a sweep takes the minimum image
under the box of its step on the periodic axes (``image_shift``), exact
because the grid holds L >= 2 cutneigh, and the displacement check
(Neighbor::decide) rebuilds the list before a pair outside it can come
within the force cutoff.  A special pair is kept with its code (a Coulomb
style still owes an excluded pair the kspace exclusion term).  Each j's
code is the largest among i's special entries naming j's tag
(ops/neighbor.py::build_neighbors); read_data gives each pair one.  A pair
that a ``neigh_modify exclude group`` pair of group bits excludes is
dropped at build, as LAMMPS's Neighbor drops it.

A row longer than K keeps its first K entries and sets the overflow flag,
which makes the run redo the segment with a larger K
(``Simulation._regrow``): a list is never cut short silently.

The kernel (``tpumd_torch/csrc/cellgrid_pairlist.cu``) takes the
candidate search out of B5, B6 and B2, the TPU kernels
tpumd/ops/pallas_charmm.py::_kernel, tpumd/ops/pallas_gran.py::_kernel
and tpumd/ops/pallas_lj.py::_kernel_fene, which tested all 27 cells at
every force evaluation; it runs once per re-bin and serves any grid the
stencil takes.
``cellgrid_pairlist`` launches it for CUDA tensors and takes the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, stencil_blocks
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, check_grid_inputs
from tpumd_torch.ops.neighbor import excluded_pairs

SBBITS = 30
NEIGHMASK = (1 << SBBITS) - 1
MAX_EXCLUDE = 4     # kMaxExcl of the kernel

counts = LaunchCounts()


def pack(j, code):
    """int32 entries j | code << 30 (the top bit wraps to the sign)."""
    v = j.long() | (code.long() << SBBITS)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def unpack(pairs):
    """(j, code) int32 of packed entries."""
    return pairs & NEIGHMASK, (pairs >> SBBITS) & 3


def image_shift(d, box: Box):
    """The image correction of x_i - x_j per component (..., 3): L times
    the nearest integer of d / L on the periodic axes, 0 on the others.
    A list sweep takes d = x_i - (x_j + shift), rounded as the stencil
    rounds x_i - (x_j + L), so both find the same contacts; the kernels
    compute it op for op (L * rint(d / L))."""
    L = box.lengths
    per = torch.tensor(box.periodic, device=d.device)
    return torch.where(per, L * torch.round(d / L), 0.0)


def partner_slots(tag, ptags):
    """(Np, P) int32 slots of the partners named by tag in ptags (Np, P)
    int32 (0: none, slot -1): tags are 1..natoms, so an (Np + 1) table of
    slots by tag holds them (empty slots write entry 0)."""
    np_ = tag.shape[0]
    slot_of = torch.full((np_ + 1,), -1, dtype=torch.int32,
                         device=tag.device)
    slot_of[tag.long()] = torch.arange(np_, dtype=torch.int32,
                                       device=tag.device)
    return torch.where(ptags > 0, slot_of[ptags.long()], -1)


def cellgrid_pairlist_plain(x, valid, tag, stags, scodes, box: Box,
                            cfg: CellGridConfig, kmax: int, gmask=None,
                            exclude_bits=()):
    """Plain PyTorch version of the kernel over ``stencil_blocks``: (pairs,
    npairs, max_pairs () int32 the longest row before truncation,
    overflow () bool).  Blocks of at most 2^22 candidates on the CPU
    (memory), 2^26 on a card."""
    np_, K = cfg.capacity, kmax
    dev = x.device
    slot = torch.arange(np_, device=dev)
    pairs = slot.to(torch.int32)[:, None].repeat(1, K)
    count = torch.zeros(np_, dtype=torch.int64, device=dev)
    cutsq = cfg.cutneigh * cfg.cutneigh
    per_slot = (slot,) if not exclude_bits else (slot, gmask)
    for _, _, r2, mask, per in stencil_blocks(
            x, valid, box, cfg, per_slot,
            max_pairs=1 << (22 if dev.type == "cpu" else 26)):
        rowlen = r2.shape[-1]
        hit = mask & (r2 < cutsq)
        if exclude_bits:
            hit &= ~excluded_pairs(*per[1], exclude_bits)
        flat = torch.nonzero(hit.reshape(-1)).reshape(-1)
        ii = flat // rowlen
        i = per[0][0].reshape(-1)[ii]
        j = per[0][1].reshape(-1)[(flat // (cfg.cap * rowlen)) * rowlen
                                  + flat % rowlen]
        # hits of a row arrive in stencil order, rows in slot order
        rank = torch.arange(flat.numel(), device=dev) - torch.searchsorted(
            ii, ii)
        pos = count[i] + rank
        count.index_add_(0, i, torch.ones_like(i))
        code = torch.zeros_like(j)
        if stags is not None and stags.shape[1]:
            match = stags[i] == tag[j][:, None]
            code = torch.amax(torch.where(match, scodes[i], 0), dim=1)
        ok = pos < K
        pairs[i[ok], pos[ok]] = pack(j[ok], code[ok])
    max_pairs = torch.max(count).to(torch.int32)
    return (pairs, torch.clamp(count, max=K).to(torch.int32), max_pairs,
            max_pairs > K)


_FN_NAMES = {torch.float32: "tpumd_cellgrid_pairlist_f32",
             torch.float64: "tpumd_cellgrid_pairlist_f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = ([_P] * 4 + [_I] + [_P] * 3 + [_I] + [_P] * 4 + [_I] * 8
             + [_D, _P])


def _check(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"cellgrid_pairlist: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def cellgrid_pairlist(x, valid, tag, stags, scodes, box: Box,
                      cfg: CellGridConfig, kmax: int, gmask=None,
                      exclude_bits=()):
    """The pair list at cfg.cutneigh of a binned grid of wrapped
    positions, rows of K = kmax entries: (pairs (Np, K) int32, npairs (Np,)
    int32, max_pairs () int32, overflow () bool).  stags / scodes (Np, S)
    int32, each slot's special partners' tags (0: none) and codes, or None
    for a style without special pairs; tag (Np,) int32; exclude_bits
    ((b1, b2), ...) the group-bit pairs whose pairs the list drops, read
    from gmask (Np,) int32."""
    if kmax < 1:
        raise ValueError(f"cellgrid_pairlist: kmax {kmax}; a list needs "
                         f"K >= 1")
    exclude_bits = tuple(exclude_bits)
    if exclude_bits and gmask is None:
        raise ValueError("cellgrid_pairlist: exclusions need gmask")
    if len(exclude_bits) > MAX_EXCLUDE:
        raise NotImplementedError(f"cellgrid_pairlist: more than "
                                  f"{MAX_EXCLUDE} neigh_modify exclude "
                                  "group pairs")
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return cellgrid_pairlist_plain(x, valid, tag, stags, scodes, box,
                                       cfg, kmax, gmask, exclude_bits)
    if x.device.type != "cuda":
        raise ValueError(f"cellgrid_pairlist: no kernel for device "
                         f"{x.device}")
    check_grid_inputs(x, valid, box, cfg, "cellgrid_pairlist",
                      periodic_only=False)
    np_, K = cfg.capacity, kmax
    if np_ > NEIGHMASK:
        raise ValueError(f"cellgrid_pairlist: {np_} slots do not fit the "
                         f"{SBBITS} index bits of an entry")
    _check("tag", tag, torch.int32, (np_,), x.device)
    S = 0 if stags is None else stags.shape[1]
    sslots = None
    if S:
        _check("special_tags", stags, torch.int32, (np_, S), x.device)
        _check("special_codes", scodes, torch.int32, (np_, S), x.device)
        sslots = partner_slots(tag, stags)
    if exclude_bits:
        _check("gmask", gmask, torch.int32, (np_,), x.device)
    excl = (ctypes.c_int * (2 * MAX_EXCLUDE))(
        *[int(b) for pair in exclude_bits for b in pair])
    # each cell's last valid slot + 1: the kernel walks no further
    extent = torch.amax(valid.view(cfg.ncells, cfg.cap) * torch.arange(
        1, cfg.cap + 1, dtype=torch.int32, device=x.device), dim=1)
    fn = _build.kernel_function(_FN_NAMES[x.dtype], _ARGTYPES)
    pairs = torch.empty((np_, K), dtype=torch.int32, device=x.device)
    npairs = torch.empty(np_, dtype=torch.int32, device=x.device)
    # the longest row (atomicMax) and the overflow flag
    stat = torch.zeros(2, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), valid.data_ptr(),
                sslots.data_ptr() if S else None,
                scodes.data_ptr() if S else None, S, extent.data_ptr(),
                box.lengths.data_ptr(),
                gmask.data_ptr() if exclude_bits else None,
                len(exclude_bits), ctypes.cast(excl, ctypes.c_void_p),
                pairs.data_ptr(), npairs.data_ptr(), stat.data_ptr(),
                cfg.nx, cfg.ny, cfg.nz, cfg.cap,
                *(int(p) for p in box.periodic), K,
                cfg.cutneigh * cfg.cutneigh,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cellgrid_pairlist kernel launch failed: CUDA "
                           f"error {rc}")
    counts.kernel_launches += 1
    return pairs, npairs, stat[0], stat[1] != 0
