"""The cell grid's pair list: the CUDA build and refresh kernels, their
wrappers and their plain PyTorch versions.

A pair list holds, for every grid slot i, every valid j != i within
cutneigh of it when the list was built, in the order the 27-cell stencil
visits them (z, y, x offsets, then slot; a non-periodic axis drops the
offsets that alias, as ``cellgrid._offs`` does), as LAMMPS's full lists
hold them: ``pairs`` (Np, K) int32 of entries ``j | code << 30`` (SBBITS = 30,
NEIGHMASK, src/neighbor.h), code the pair's special_bonds code 0-3, and
``npairs`` (Np,) int32, each row's count.  A row's tail past its count is
unspecified, and no sweep reads it: the kernel writes the live entries
only, the plain build pads the tail with the row's own slot.  Entries address
grid slots and carry no image shift: a sweep takes the minimum image
under the box of its step on the periodic axes (``image_shift``), exact
because the grid holds L >= 2 cutneigh.  A special pair is kept with its
code (a Coulomb style still owes an excluded pair the kspace exclusion
term).  Each j's code is the largest among i's special entries naming j's
tag (ops/neighbor.py::build_neighbors); read_data gives each pair one.  A
pair that a ``neigh_modify exclude group`` pair of group bits excludes is
dropped at build, as LAMMPS's Neighbor drops it.

The list is built at every re-bin, and a sweep of it sums the same pairs
as the stencil only while every valid atom is within skin/2 of its
position at the list's build (less the box corners' move under a fix that
moves the box): a pair within the cutoff then was within cutneigh.  Where
the every/delay/check schedule does not establish that at a force
evaluation (check no, the steps before the delay, every > 1, or a list
refreshed since the re-bin), ``refresh_pairlist`` does: it rebuilds the
list in place from the standing bins where some atom moved too far, the
decision made on the card.  A refresh is not a rebuild: the bins, the
slot order and the rebuild count stay the schedule's.  ``ListHold``
carries what it needs from the re-bin: the positions (and box corners) of
the list's last build, each cell's extent and the special partners'
slots.

A row longer than K keeps its first K entries and sets the overflow flag
(``stat[1]``, ORed into the grid state's flag that the run reads once a
segment), which makes the run redo the segment with a larger K
(``Simulation._regrow``): a list is never cut short silently.

The kernels (``tpumd_torch/csrc/cellgrid_pairlist.cu``) take the
candidate search out of B1, B2, B4, B5 and B6, the TPU kernels
tpumd/ops/pallas_lj.py::_kernel and ::_kernel_fene,
tpumd/ops/pallas_eam.py::_force_kernel, tpumd/ops/pallas_charmm.py::
_kernel and tpumd/ops/pallas_gran.py::_kernel, which tested all 27 cells at
every force evaluation; the build runs once per re-bin and serves any grid
the stencil takes.  ``cellgrid_pairlist`` and ``refresh_pairlist`` launch
them for CUDA tensors and take the plain versions only for CPU tensors;
they never fall back from one to the other.  The build takes G lanes a
slot, 1 on cells of at most 64 slots and ``WIDE_LANES`` on larger ones
(the kernel's launch rule); ``cellgrid_pairlist``'s ``lanes`` forces
either, for the card's tests.
"""

from __future__ import annotations

import ctypes
import itertools
import weakref
from typing import NamedTuple

import torch

from tpumd_torch.core.state import Box
from tpumd_torch.ops import _build
from tpumd_torch.ops.cellgrid import CellGridConfig, displacement_exceeded, \
    stencil_blocks
from tpumd_torch.ops.lj_cellgrid import LaunchCounts, check_grid_inputs
from tpumd_torch.ops.neighbor import excluded_pairs

SBBITS = 30
NEIGHMASK = (1 << SBBITS) - 1
MAX_EXCLUDE = 4     # kMaxExcl of the kernel
WIDE_LANES = 16     # kLanesBuild of the kernel: its G on large cells
LANES = (1, WIDE_LANES)    # every G the launch rule can pick

counts = LaunchCounts()            # builds at set-up and re-bins
refresh_counts = LaunchCounts()    # gated refreshes between re-bins
# each refresh launch brings a new stamp (see the kernel)
_stamps = itertools.count(1)


class ListHold(NamedTuple):
    """What a list refreshed between re-bins keeps from its re-bin: x (Np,
    3) and box (6,: lo, hi; None without a fix that moves the box), the
    positions and corners of the list's last build, written by each build;
    the build's inputs tag, stags, scodes, gmask and exclude_bits; for the
    kernel each cell's extent (ncells,) int32 and the special partners'
    slots sslots (Np, S) int32 (None on the CPU or where S = 0), all fixed
    until the next re-bin; and prepared, a list that holds the refresh
    kernel's prepared arguments once a refresh launched it."""
    x: torch.Tensor
    box: torch.Tensor | None
    tag: torch.Tensor
    stags: torch.Tensor | None
    scodes: torch.Tensor | None
    gmask: torch.Tensor | None
    exclude_bits: tuple
    extent: torch.Tensor | None
    sslots: torch.Tensor | None
    prepared: list | None


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


def list_entries(x, box: Box, pairs, npairs, with_codes=False, rows=None):
    """(i, j, d, r2) of a list's live code-0 entries: i and j (n,) int64
    slots, d (n, 3) x_i - (x_j + image_shift) and r2 (n,) its squared
    length, rounded as the list kernels round them; with_codes, of every
    live entry, and (n,) their codes after them.  rows, where given, the
    slots whose rows count (the kernels' rows: the owned ones on a rank's
    local grid), the entries still in slot order."""
    kk = max(int(npairs.max()), 1)
    j, code = unpack(pairs[:, :kk])
    live = (torch.arange(kk, device=x.device)[None, :]
            < npairs[:, None].long())
    if rows is not None:
        take = torch.zeros(npairs.shape[0], dtype=torch.bool,
                           device=x.device)
        take[rows] = True
        live &= take[:, None]
    if not with_codes:
        live &= code == 0
    i, col = torch.nonzero(live, as_tuple=True)
    j = j[i, col].long()
    d = x[i] - (x[j] + image_shift(x[i] - x[j], box))
    out = (i, j, d, d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    return out + (code[i, col],) if with_codes else out


def half_virial(fp, d):
    """(6,) half the sum of fpair d_a d_b over the pairs (xx, yy, zz, xy,
    xz, yz): each unordered pair is met from both atoms."""
    return 0.5 * torch.stack([
        torch.sum(fp * d[:, a] * d[:, b])
        for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])


def new_stat(device):
    """A list's (4,) int32 status words, zero: the longest row seen, the
    overflow flag, the refreshes taken and the last refresh's gate stamp.
    A grid state keeps one over its re-bins, so that the first two hold
    the largest over every build and refresh since the grid's set-up."""
    return torch.zeros(4, dtype=torch.int32, device=device)


_FN_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = ([_P] * 4 + [_I] + [_P] * 5 + [_I] + [_P] * 6 + [_I] * 9
             + [_D, _D, _I, _I, _P])
_RUN_ARGTYPES = [_P] * 5 + [_I, _P]


def _check(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"cellgrid_pairlist: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_exclusions(exclude_bits, gmask):
    if exclude_bits and gmask is None:
        raise ValueError("cellgrid_pairlist: exclusions need gmask")
    if len(exclude_bits) > MAX_EXCLUDE:
        raise NotImplementedError(f"cellgrid_pairlist: more than "
                                  f"{MAX_EXCLUDE} neigh_modify exclude "
                                  "group pairs")


def _extent(valid, cfg: CellGridConfig):
    """Each cell's last valid slot + 1: the kernel walks no further."""
    return torch.amax(valid.view(cfg.ncells, cfg.cap) * torch.arange(
        1, cfg.cap + 1, dtype=torch.int32, device=valid.device), dim=1)


def pairlist_hold(x, valid, tag, stags, scodes, cfg: CellGridConfig,
                  gmask=None, exclude_bits=(), box_term=False,
                  keep=True) -> ListHold:
    """The ListHold of a list about to be built at a re-bin on this grid,
    its x (and with box_term, a fix that moves the box, its box) for the
    build to write; without keep, only the build's inputs (x and box
    None)."""
    exclude_bits = tuple(exclude_bits)
    _check_exclusions(exclude_bits, gmask)
    extent = sslots = None
    if x.device.type == "cuda":
        extent = _extent(valid, cfg)
        if stags is not None and stags.shape[1]:
            sslots = partner_slots(tag, stags)
    return ListHold(
        x=torch.empty_like(x) if keep else None,
        box=(torch.empty(6, dtype=x.dtype, device=x.device)
             if keep and box_term else None),
        tag=tag, stags=stags, scodes=scodes, gmask=gmask,
        exclude_bits=exclude_bits, extent=extent, sslots=sslots,
        prepared=[] if keep else None)


def _write_hold(hold: ListHold, x, box: Box):
    hold.x.copy_(x)
    if hold.box is not None:
        hold.box.copy_(torch.cat([box.lo, box.hi]))


def cellgrid_pairlist(x, valid, tag, stags, scodes, box: Box,
                      cfg: CellGridConfig, kmax: int, gmask=None,
                      exclude_bits=(), stat=None, hold: ListHold = None,
                      lanes: int | None = None):
    """The pair list at cfg.cutneigh of a binned grid of wrapped
    positions, rows of K = kmax entries: (pairs (Np, K) int32, npairs (Np,)
    int32, max_pairs () int32, overflow () bool).  stags / scodes (Np, S)
    int32, each slot's special partners' tags (0: none) and codes, or None
    for a style without special pairs; tag (Np,) int32; exclude_bits
    ((b1, b2), ...) the group-bit pairs whose pairs the list drops, read
    from gmask (Np,) int32.  stat: the (4,) status words (``new_stat``)
    the build takes its longest row and overflow into, kept by the caller;
    by default fresh ones.  hold: the ListHold (``pairlist_hold``) whose
    positions and box corners the build writes, for a list refreshed
    between re-bins.  lanes: the kernel's G (one of ``LANES``) where a
    test forces it, else the kernel's launch rule picks it."""
    if kmax < 1:
        raise ValueError(f"cellgrid_pairlist: kmax {kmax}; a list needs "
                         f"K >= 1")
    exclude_bits = tuple(exclude_bits)
    _check_exclusions(exclude_bits, gmask)
    if stat is None:
        stat = new_stat(x.device)
    if x.device.type == "cpu":
        counts.plain_calls += 1
        pairs, npairs, longest, over = cellgrid_pairlist_plain(
            x, valid, tag, stags, scodes, box, cfg, kmax, gmask,
            exclude_bits)
        stat[0] = torch.maximum(stat[0], longest)
        stat[1] |= over.to(torch.int32)
        if hold is not None:
            _write_hold(hold, x, box)
        return pairs, npairs, stat[0], stat[1] != 0
    np_ = cfg.capacity
    pairs = torch.empty((np_, kmax), dtype=torch.int32, device=x.device)
    npairs = torch.empty(np_, dtype=torch.int32, device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"cellgrid_pairlist: no kernel for device "
                         f"{x.device}")
    if hold is None:
        hold = pairlist_hold(x, valid, tag, stags, scodes, cfg, gmask,
                             exclude_bits, keep=False)
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"cellgrid_pairlist: lanes {lanes}, not one of "
                         f"{LANES}")
    args = _args(x, valid, box, cfg, pairs, npairs, stat, hold, 0, 0,
                 lanes or 0)
    fn = _build.kernel_function(f"tpumd_cellgrid_pairlist_"
                                f"{_FN_SUFFIX[x.dtype]}", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"cellgrid_pairlist kernel launch failed: CUDA "
                           f"error {rc}")
    counts.kernel_launches += 1
    return pairs, npairs, stat[0], stat[1] != 0


def refresh_pairlist(x, valid, box: Box, cfg: CellGridConfig, pairs, npairs,
                     stat, hold: ListHold):
    """Rebuild the list (pairs, npairs) in place from the standing bins,
    and hold.x (and hold.box) with it, where some valid atom moved more
    than cfg.skin/2 since hold.x, less half the box corners' move since
    hold.box where that is kept (``cellgrid.displacement_exceeded``); a
    refresh counts in stat[2] and ORs its overflow into stat[1].  On a
    card the decision stays there: two launches (the flag, then a build
    that returns at once where it is clear), no read by the host; the
    arguments that stay fixed between re-bins are checked and handed to
    the library at the first call (``_PreparedRefresh``)."""
    stamp = next(_stamps) % (1 << 30) + 1
    if x.device.type == "cpu":
        refresh_counts.plain_calls += 1
        refresh_pairlist_plain(x, valid, box, cfg, pairs, npairs, stat, hold,
                               stamp)
        return
    if x.device.type != "cuda":
        raise ValueError(f"cellgrid_pairlist: no kernel for device "
                         f"{x.device}")
    prep = hold.prepared
    key = (id(cfg), box.periodic, valid.data_ptr(), pairs.data_ptr(),
           npairs.data_ptr(), stat.data_ptr())
    if not prep or prep[0].key != key:
        prep[:] = [_PreparedRefresh(key, x, valid, box, cfg, pairs, npairs,
                                    stat, hold)]
    prep[0](x, box, stamp)
    refresh_counts.kernel_launches += 1


class _PreparedRefresh:
    """The refresh kernel's arguments that stay fixed between re-bins (the
    list, its counts, status words and hold, the bins' extents, the grid),
    checked once and kept by the library (the prepare entry); a call
    checks and passes only the step's positions, box and stamp, since the
    refresh runs at most steps of a deck whose host is the bottleneck."""

    def __init__(self, key, x, valid, box: Box, cfg: CellGridConfig, pairs,
                 npairs, stat, hold: ListHold):
        self.key = key
        self.np, self.dtype, self.device = cfg.capacity, x.dtype, x.device
        self.box_term = hold.box is not None
        args = _args(x, valid, box, cfg, pairs, npairs, stat, hold, 0,
                     int(self.box_term), 0)
        suffix = _FN_SUFFIX[x.dtype]
        prepare = _build.kernel_function(
            f"tpumd_cellgrid_pairlist_refresh_prepare_{suffix}", _ARGTYPES,
            ctypes.c_void_p)
        self.handle = prepare(*args)
        if not self.handle:
            raise ValueError("cellgrid_pairlist: the refresh's arguments "
                             "were refused")
        # the tensors whose pointers the library keeps live with the handle
        # (not the hold itself, whose list holds this object)
        self._tensors = (valid, pairs, npairs, stat, hold.x, hold.box,
                         hold.extent, hold.sslots, hold.scodes, hold.gmask)
        self._run = _build.kernel_function(
            f"tpumd_cellgrid_pairlist_refresh_{suffix}", _RUN_ARGTYPES)
        weakref.finalize(self, _build.kernel_function(
            f"tpumd_cellgrid_pairlist_refresh_release_{suffix}", [_P],
            None), self.handle)

    def __call__(self, x, box: Box, stamp: int):
        lengths = box.lengths
        for what, t, shape in (("x", x, (self.np, 3)),
                               ("box lengths", lengths, (3,))):
            if (t.dtype != self.dtype or t.device != self.device
                    or t.shape != shape or not t.is_contiguous()):
                raise ValueError(f"cellgrid_pairlist refresh: {what} must be "
                                 f"a contiguous {self.dtype} {shape} tensor "
                                 f"on {self.device}")
        lo = hi = None
        if self.box_term:
            for what, t in (("box lo", box.lo), ("box hi", box.hi)):
                _check(what, t, self.dtype, (3,), self.device)
            lo, hi = box.lo.data_ptr(), box.hi.data_ptr()
        with torch.cuda.device(self.device):
            rc = self._run(self.handle, x.data_ptr(), lengths.data_ptr(), lo,
                           hi, stamp,
                           torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cellgrid_pairlist refresh launch failed: "
                               f"CUDA error {rc}")


def refresh_pairlist_plain(x, valid, box: Box, cfg: CellGridConfig, pairs,
                           npairs, stat, hold: ListHold, stamp: int):
    """Plain PyTorch version of the refresh kernel."""
    corners = (None, None) if hold.box is None else (hold.box[:3],
                                                     hold.box[3:])
    if not bool(displacement_exceeded(x, hold.x, valid, box, cfg.skin,
                                      *corners)):
        return
    stat[3] = stamp
    new, count, longest, over = cellgrid_pairlist_plain(
        x, valid, hold.tag, hold.stags, hold.scodes, box, cfg,
        pairs.shape[1], hold.gmask, hold.exclude_bits)
    pairs.copy_(new)
    npairs.copy_(count)
    stat[0] = torch.maximum(stat[0], longest)
    stat[1] |= over.to(torch.int32)
    stat[2] += 1
    _write_hold(hold, x, box)


def _args(x, valid, box: Box, cfg: CellGridConfig, pairs, npairs, stat,
          hold: ListHold, stamp: int, box_term: int, lanes: int) -> list:
    """Check the CUDA inputs of the build or the refresh and return the
    arguments of their library entries (``_ARGTYPES``)."""
    check_grid_inputs(x, valid, box, cfg, "cellgrid_pairlist",
                      periodic_only=False)
    if valid.data_ptr() % 4:
        raise ValueError("cellgrid_pairlist: valid must start at a 4-byte "
                         "boundary (the kernel stages it as words)")
    np_, K, dev = cfg.capacity, pairs.shape[1], x.device
    if np_ > NEIGHMASK:
        raise ValueError(f"cellgrid_pairlist: {np_} slots do not fit the "
                         f"{SBBITS} index bits of an entry")
    _check("pairs", pairs, torch.int32, (np_, K), dev)
    _check("npairs", npairs, torch.int32, (np_,), dev)
    _check("stat", stat, torch.int32, (4,), dev)
    _check("tag", hold.tag, torch.int32, (np_,), dev)
    _check("extent", hold.extent, torch.int32, (cfg.ncells,), dev)
    S = 0 if hold.stags is None else hold.stags.shape[1]
    if S:
        _check("special_slots", hold.sslots, torch.int32, (np_, S), dev)
        _check("special_codes", hold.scodes, torch.int32, (np_, S), dev)
    if hold.exclude_bits:
        _check("gmask", hold.gmask, torch.int32, (np_,), dev)
    if hold.x is not None:
        _check("hold x", hold.x, x.dtype, (np_, 3), dev)
    corners = (None, None, None)
    if hold.box is not None:
        _check("hold box", hold.box, x.dtype, (6,), dev)
        for what, t in (("box lo", box.lo), ("box hi", box.hi)):
            _check(what, t, x.dtype, (3,), dev)
        corners = (box.lo.data_ptr(), box.hi.data_ptr(),
                   hold.box.data_ptr())
    excl = (ctypes.c_int * (2 * MAX_EXCLUDE))(
        *[int(b) for pair in hold.exclude_bits for b in pair])
    return [x.data_ptr(), valid.data_ptr(),
            hold.sslots.data_ptr() if S else None,
            hold.scodes.data_ptr() if S else None, S,
            hold.extent.data_ptr(), box.lengths.data_ptr(), corners[0],
            corners[1], hold.gmask.data_ptr() if hold.exclude_bits else None,
            len(hold.exclude_bits), ctypes.cast(excl, ctypes.c_void_p),
            pairs.data_ptr(), npairs.data_ptr(), stat.data_ptr(),
            None if hold.x is None else hold.x.data_ptr(), corners[2],
            cfg.nx, cfg.ny, cfg.nz, cfg.cap,
            *(int(p) for p in box.periodic), K, lanes,
            cfg.cutneigh * cfg.cutneigh, cfg.skin, stamp, box_term,
            torch.cuda.current_stream(dev).cuda_stream]
