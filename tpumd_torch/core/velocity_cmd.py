"""velocity command: create/scale/zero thermal velocities (host-side setup).

Reimplements Velocity::create (src/velocity.cpp:160-400) for the
deterministic ``loop geom`` path (per-atom coord-hashed RanPark streams),
plus momentum zeroing and temperature rescaling.  ``loop geom`` is the mode
every benchmark deck uses; it is decomposition-invariant by construction.
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
) -> np.ndarray:
    """Velocities for ``velocity all create T seed loop geom [dist ...]``.

    coords: (N,3) positions, masses: (N,) per-atom mass.
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

    # rescale to target temperature (Velocity::rescale + ComputeTemp)
    if extra_dof is None:
        extra_dof = dimension
    dof = dimension * n - extra_dof
    t_current = mvv2e * float((masses[:, None] * v * v).sum()) / (dof * boltz)
    if t_current <= 0.0:
        raise ValueError("Attempting to rescale a 0.0 temperature")
    v *= np.sqrt(t_desired / t_current)
    return v
