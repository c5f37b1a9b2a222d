"""Core simulation state: the box and the per-atom arrays as torch tensors.

PyTorch counterpart of tpumd/core/state.py (the reference's Atom/Domain
data model, src/atom.h, src/domain.h) for orthogonal and triclinic boxes
whose axes are each periodic or not (boundary f/s/m).  Plain dataclasses
of tensors; every tensor lives on the device and in the float dtype the
caller passes.
Per-atom arrays are padded to a fixed capacity; padded slots carry tag 0,
type 0, charge 0, radius 0 and rmass 0.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Box:
    """Orthogonal or triclinic box: lo, hi are (3,) tensors on the device;
    ``periodic`` is a static per-axis flag (a non-periodic axis is never
    wrapped and takes no minimum-image correction: boundary f, s or m).
    A triclinic box also holds its tilt factors (xy, xz, yz) as a (3,)
    tensor; an orthogonal one holds None."""

    lo: torch.Tensor
    hi: torch.Tensor
    periodic: tuple = (True, True, True)
    tilt: torch.Tensor | None = None

    @property
    def istriclinic(self) -> bool:
        return self.tilt is not None

    @functools.cached_property
    def lengths(self) -> torch.Tensor:
        # computed once per box: the force kernel reads it every step
        return self.hi - self.lo

    @property
    def volume(self) -> torch.Tensor:
        ell = self.lengths
        return ell[0] * ell[1] * ell[2]

    @staticmethod
    def orthogonal(lo, hi, *, device, dtype, periodic=(True, True, True)):
        return Box(lo=torch.as_tensor(np.asarray(lo), dtype=dtype,
                                      device=device),
                   hi=torch.as_tensor(np.asarray(hi), dtype=dtype,
                                      device=device),
                   periodic=tuple(bool(p) for p in periodic))

    @staticmethod
    def triclinic(lo, hi, tilt, *, device, dtype,
                  periodic=(True, True, True)):
        box = Box.orthogonal(lo, hi, device=device, dtype=dtype,
                             periodic=periodic)
        return box.replace(tilt=torch.as_tensor(np.asarray(tilt),
                                                dtype=dtype, device=device))

    def replace(self, **kw) -> "Box":
        return dataclasses.replace(self, **kw)

    def to(self, *, device, dtype) -> "Box":
        return self.replace(**{k: getattr(self, k).to(device=device,
                                                      dtype=dtype)
                               for k in ("lo", "hi", "tilt")
                               if getattr(self, k) is not None})

    def lengths_np(self) -> np.ndarray:
        """Box lengths on the host, as float64 (setup-time decisions)."""
        return self.lengths.detach().cpu().numpy().astype(np.float64)

    # -- triclinic transforms (Domain::x2lamda/lamda2x, src/domain.cpp;
    # tpumd/core/state.py:55-92) --
    def x2lamda(self, x):
        ell = self.lengths
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        d = x - self.lo
        lz = d[..., 2] / ell[2]
        ly = (d[..., 1] - yz * lz) / ell[1]
        lx = (d[..., 0] - xy * ly - xz * lz) / ell[0]
        return torch.stack([lx, ly, lz], dim=-1)

    def lamda2x(self, lam):
        ell = self.lengths
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        x = ell[0] * lam[..., 0] + xy * lam[..., 1] + xz * lam[..., 2]
        y = ell[1] * lam[..., 1] + yz * lam[..., 2]
        z = ell[2] * lam[..., 2]
        return torch.stack([x, y, z], dim=-1) + self.lo

    def perp_widths(self) -> np.ndarray:
        """Perpendicular widths (host, float64): the volume over each
        face's area, the triclinic counterpart of the lengths when cells
        are counted."""
        ell = self.lengths_np()
        xy, xz, yz = self.tilt.detach().cpu().numpy().astype(np.float64)
        a = np.array([ell[0], 0.0, 0.0])
        b = np.array([xy, ell[1], 0.0])
        c = np.array([xz, yz, ell[2]])
        vol = ell[0] * ell[1] * ell[2]
        return np.array([vol / np.linalg.norm(np.cross(b, c)),
                         vol / np.linalg.norm(np.cross(a, c)),
                         vol / np.linalg.norm(np.cross(a, b))])

    def widths_np(self) -> np.ndarray:
        """The widths that cells are counted on: the perpendicular widths
        of a triclinic box, the lengths of an orthogonal one."""
        return self.perp_widths() if self.istriclinic else self.lengths_np()


@dataclasses.dataclass(frozen=True)
class MDState:
    """Per-atom dynamical state + box.  The molecular and charge fields
    are None for systems without them.  Every per-atom field permutes
    with the atoms at each re-bin, the special lists included."""

    x: torch.Tensor       # (N, 3) positions
    v: torch.Tensor       # (N, 3) velocities
    f: torch.Tensor       # (N, 3) forces
    type: torch.Tensor    # (N,) int32, 1-based type ids (0 = padding)
    tag: torch.Tensor     # (N,) int32 global atom ids (1-based; 0 = padding)
    image: torch.Tensor   # (N, 3) int32 periodic image flags
    box: Box
    molecule: torch.Tensor | None = None     # (N,) int32 molecule id
    bond_tags: torch.Tensor | None = None    # (N, B) int32 partner tags
    bond_btypes: torch.Tensor | None = None  # (N, B) int32 bond types
    q: torch.Tensor | None = None            # (N,) charges
    # 1-2/1-3/1-4 special neighbors: partner tags (0 = none) and their
    # codes 1/2/3, which index the special_bonds weight tables
    special_tags: torch.Tensor | None = None   # (N, S) int32
    special_codes: torch.Tensor | None = None  # (N, S) int32
    # group membership bits (bit 1 = group all), set by the first group
    # command (the reference's atom->mask)
    gmask: torch.Tensor | None = None    # (N,) int32
    # atom_style sphere (src/atom_vec_sphere.cpp): finite-size particles
    radius: torch.Tensor | None = None   # (N,)
    rmass: torch.Tensor | None = None    # (N,) per-atom mass
    omega: torch.Tensor | None = None    # (N, 3) angular velocity
    torque: torch.Tensor | None = None   # (N, 3)
    # per-atom tables that ride the atoms through every re-bin,
    # compaction and insertion, so that they stay with their tags: a fix's
    # per-atom state by its key (fix wall/gran's shear history) and a
    # granular style's contact history between a run and the next set-up
    peratom: dict | None = None          # name -> (N, ...) tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)


# every per-atom field of MDState (for generic permute/pad/compact)
PER_ATOM_FIELDS = ("x", "v", "f", "type", "tag", "image", "molecule",
                   "bond_tags", "bond_btypes", "q", "special_tags",
                   "special_codes", "gmask", "radius", "rmass", "omega",
                   "torque")


def map_per_atom(state: MDState, fn) -> MDState:
    """Apply fn(tensor) to every per-atom field that is set, the tables
    of ``peratom`` included."""
    out = {k: fn(getattr(state, k)) for k in PER_ATOM_FIELDS
           if getattr(state, k) is not None}
    if state.peratom:
        out["peratom"] = {k: fn(a) for k, a in state.peratom.items()}
    return state.replace(**out)


def make_state(x, v, types, box: Box, *, tags=None, image=None,
               molecule=None, q=None, radius=None, rmass=None, omega=None,
               device, dtype) -> MDState:
    """Build an MDState from host arrays (no padding); a sphere state
    (radius given) starts with zero torque, and zero omega unless given."""
    n = x.shape[0]
    if tags is None:
        tags = np.arange(1, n + 1, dtype=np.int32)
    if image is None:
        image = np.zeros((n, 3), np.int32)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def floats(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dtype, device=device)

    xt = floats(x)
    sphere = radius is not None
    return MDState(
        x=xt, v=floats(v), f=torch.zeros_like(xt),
        type=ints(types), tag=ints(tags), image=ints(image),
        box=box.to(device=device, dtype=dtype),
        molecule=None if molecule is None else ints(molecule),
        q=floats(q), radius=floats(radius), rmass=floats(rmass),
        omega=(torch.zeros_like(xt) if sphere and omega is None
               else floats(omega)),
        torque=torch.zeros_like(xt) if sphere else None)


def _zero_aperiodic(a: torch.Tensor, box: Box) -> torch.Tensor:
    """a (..., 3) with its non-periodic columns set to 0 (no host copy)."""
    if all(box.periodic):
        return a
    a = a.clone()
    for c, p in enumerate(box.periodic):
        if not p:
            a[..., c] = 0
    return a


def wrap_pbc(state: MDState) -> MDState:
    """Remap atoms into the box along its periodic axes, updating image
    flags (Domain::pbc, src/domain.cpp; tpumd/core/state.py::wrap_pbc);
    non-periodic axes are left as they are.  A triclinic box wraps in
    lamda space."""
    box = state.box
    if box.istriclinic:
        lam = box.x2lamda(state.x)
        shift = _zero_aperiodic(torch.floor(lam).to(torch.int32), box)
        x = box.lamda2x(lam - shift.to(lam.dtype))
        return state.replace(x=x, image=state.image + shift)
    ell = box.lengths
    rel = (state.x - box.lo) / ell
    shift = _zero_aperiodic(torch.floor(rel).to(torch.int32), box)
    x = state.x - shift * ell
    return state.replace(x=x, image=state.image + shift)


def minimum_image_c(dc: torch.Tensor, box: Box, c: int) -> torch.Tensor:
    """Nearest image of the c-th component of displacements (orthogonal
    boxes; tpumd/core/state.py:94-101)."""
    if box.istriclinic:
        raise ValueError("minimum_image_c: use minimum_image for a "
                         "triclinic box")
    if not box.periodic[c]:
        return dc
    ell = box.lengths[c]
    return dc - ell * torch.round(dc / ell)


def minimum_image(d: torch.Tensor, box: Box) -> torch.Tensor:
    """Nearest-image displacement, skipping non-periodic axes.  A
    triclinic box corrects z, then y, then x, each carrying its tilt
    (Domain::minimum_image, src/domain.cpp; tpumd/core/state.py:104),
    which holds for tilts within half the box."""
    ell = box.lengths
    if box.istriclinic:
        xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        if box.periodic[2]:
            nz = torch.round(dz / ell[2])
            dz = dz - ell[2] * nz
            dy = dy - yz * nz
            dx = dx - xz * nz
        if box.periodic[1]:
            ny = torch.round(dy / ell[1])
            dy = dy - ell[1] * ny
            dx = dx - xy * ny
        if box.periodic[0]:
            dx = dx - ell[0] * torch.round(dx / ell[0])
        return torch.stack([dx, dy, dz], dim=-1)
    return d - _zero_aperiodic(ell * torch.round(d / ell), box)


def tag_rows(tag: torch.Tensor, natoms: int) -> torch.Tensor:
    """(natoms,) int64: the row of each tag (tag - 1 -> row), on the device
    without a read (a scatter; the padding rows, tag 0, land in a slot
    that is dropped)."""
    rows = torch.zeros(natoms + 1, dtype=torch.int64, device=tag.device)
    rows.scatter_(0, tag.long(), torch.arange(tag.shape[0], device=tag.device))
    return rows[1:]
