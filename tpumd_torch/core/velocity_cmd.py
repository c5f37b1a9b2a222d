"""velocity command: create, set, scale, ramp and zero (host-side setup).

Reimplements Velocity::create (src/velocity.cpp:160-400) for the
deterministic ``loop geom`` path (per-atom coord-hashed RanPark streams),
plus momentum and rotation zeroing and temperature rescaling, and the
set, scale, ramp and zero styles on a group (tpumd/script/parser.py:
913-1011).  ``loop geom`` is the mode every benchmark deck uses; it is
decomposition-invariant by construction.
"""

from __future__ import annotations

import numpy as np

from tpumd_torch.utils.ranpark import geom_uniform_triplets, jenkins_coord_seed, park_next


def _gaussian_triplets_geom(seed: int, coords: np.ndarray) -> np.ndarray:
    """3 gaussian draws per atom via Box-Muller with rejection, vectorized.

    Matches RanPark::gaussian (src/random_park.cpp:56-76) draw order per
    atom-local stream: pairs (v2*fac, v1*fac) with the second cached.
    """
    n = coords.shape[0]
    s = jenkins_coord_seed(seed, coords)
    for _ in range(5):
        s, _ = park_next(s)

    out = np.empty((n, 4), dtype=np.float64)  # 2 Box-Muller pairs per atom
    for pair in range(2):
        v1 = np.zeros(n)
        v2 = np.zeros(n)
        pending = np.ones(n, dtype=bool)
        while pending.any():
            s, u1 = park_next(s)
            s, u2 = park_next(s)
            c1 = 2.0 * u1 - 1.0
            c2 = 2.0 * u2 - 1.0
            rsq = c1 * c1 + c2 * c2
            accept = pending & (rsq < 1.0) & (rsq != 0.0)
            v1 = np.where(accept, c1, v1)
            v2 = np.where(accept, c2, v2)
            pending = pending & ~accept
        rsq = v1 * v1 + v2 * v2
        fac = np.sqrt(-2.0 * np.log(rsq) / rsq)
        out[:, 2 * pair] = v2 * fac      # "first"
        out[:, 2 * pair + 1] = v1 * fac  # "second" (cached)
    return out[:, :3]


def velocity_create_geom(
    coords: np.ndarray,
    masses: np.ndarray,
    t_desired: float,
    seed: int,
    *,
    boltz: float = 1.0,
    mvv2e: float = 1.0,
    dist: str = "uniform",
    zero_momentum: bool = True,
    dimension: int = 3,
    extra_dof: int | None = None,
    rot_xu: np.ndarray | None = None,
) -> np.ndarray:
    """Velocities for ``velocity all create T seed loop geom [dist ...]``.

    coords: (N,3) positions, masses: (N,) per-atom mass; with rot_xu, the
    unwrapped positions, the rotation is zeroed after the momentum (rot
    yes), before the rescale.
    """
    n = coords.shape[0]
    if dist == "uniform":
        u = geom_uniform_triplets(seed, coords)
        v = u - 0.5
    elif dist == "gaussian":
        v = _gaussian_triplets_geom(seed, coords)
    else:
        raise ValueError(f"unknown velocity dist {dist!r}")
    v = v / np.sqrt(masses)[:, None]
    if dimension == 2:
        v[:, 2] = 0.0

    if zero_momentum:
        p = (masses[:, None] * v).sum(axis=0)
        v = v - p / masses.sum()
    if rot_xu is not None:
        v = zero_rotation(v, rot_xu, masses, np.ones(n, bool))

    # rescale to target temperature (Velocity::rescale + ComputeTemp)
    if extra_dof is None:
        extra_dof = dimension
    dof = dimension * n - extra_dof
    t_current = mvv2e * float((masses[:, None] * v * v).sum()) / (dof * boltz)
    if t_current <= 0.0:
        raise ValueError("Attempting to rescale a 0.0 temperature")
    v *= np.sqrt(t_desired / t_current)
    return v


def velocity_set(v, sel, values, scale, sum_=False):
    """``velocity group set vx vy vz`` (Velocity::set, src/velocity.cpp:
    405-480): each component that is not None, times its scale (the
    lattice spacing under ``units lattice``), replaces (or with sum, adds
    to) the selected atoms' velocity."""
    v = v.copy()
    for d, val in enumerate(values):
        if val is not None:
            v[sel, d] = (v[sel, d] if sum_ else 0.0) + val * scale[d]
    return v


def group_temperature(v, masses, sel, dimension, mvv2e, boltz):
    """The group's temperature with dim * (n - 1) degrees of freedom
    (ComputeTemp on the group, as tpumd's velocity scale counts them)."""
    n = int(sel.sum())
    dof = dimension * n - dimension
    return mvv2e * float((masses[sel, None] * v[sel] * v[sel]).sum()) \
        / (dof * boltz)


def velocity_scale(v, masses, sel, t_new, dimension, mvv2e, boltz):
    """``velocity group scale T`` (Velocity::scale): the group's velocities
    times sqrt(T / T_group)."""
    t_cur = group_temperature(v, masses, sel, dimension, mvv2e, boltz)
    if t_cur <= 0.0:
        raise ValueError("Attempting to rescale a 0.0 temperature")
    v = v.copy()
    v[sel] *= np.sqrt(t_new / t_cur)
    return v


def velocity_ramp(v, x, sel, vdim, v_lo, v_hi, cdim, c_lo, c_hi,
                  sum_=False):
    """``velocity group ramp vdim vlo vhi dim clo chi`` (Velocity::ramp,
    src/velocity.cpp:612): component vdim of the selected atoms runs
    linearly from v_lo at c_lo to v_hi at c_hi along cdim, flat beyond."""
    frac = np.clip((x[:, cdim] - c_lo) / (c_hi - c_lo), 0.0, 1.0)
    ramp = v_lo + frac * (v_hi - v_lo)
    v = v.copy()
    v[sel, vdim] = (v[sel, vdim] if sum_ else 0.0) + ramp[sel]
    return v


def zero_momentum(v, masses, sel):
    """``velocity group zero linear`` (Velocity::zero_momentum): the
    group's centre-of-mass velocity subtracted from its atoms."""
    vcm = (masses[sel, None] * v[sel]).sum(0) / masses[sel].sum()
    v = v.copy()
    v[sel] -= vcm
    return v


def zero_rotation(v, xu, masses, sel):
    """``velocity group zero angular`` (Velocity::zero_rotation,
    src/velocity.cpp; Group::xcm, angmom, inertia, omega): the group's
    rigid rotation about its centre of mass, omega = I^-1 L from the
    unwrapped positions xu, subtracted as v -= omega x (xu - xcm).  A
    singular inertia tensor (a line of atoms) leaves omega 0, as the
    reference's Group::omega does."""
    m = masses[sel]
    xs = xu[sel]
    xcm = (m[:, None] * xs).sum(0) / m.sum()
    dx = xs - xcm
    angmom = (m[:, None] * np.cross(dx, v[sel])).sum(0)
    r2 = (dx * dx).sum(1)
    inertia = (m[:, None, None] * (r2[:, None, None] * np.eye(3)
                                   - dx[:, :, None] * dx[:, None, :])).sum(0)
    if abs(np.linalg.det(inertia)) > 0.0:
        omega = np.linalg.solve(inertia, angmom)
    else:
        omega = np.zeros(3)
    v = v.copy()
    v[sel] -= np.cross(omega, dx)
    return v
