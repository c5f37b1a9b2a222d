"""Park-Miller RNG, vectorized over atoms with numpy.

Bit-exact reimplementation of the reference's RanPark generator
(src/random_park.cpp): the minimal-standard Lehmer generator with
Schrage's algorithm, plus the ``reset(seed, coord)`` variant that derives a
per-atom seed from the Jenkins one-at-a-time hash of the caller seed's and
the coordinate triple's raw bytes.  This is what makes
``velocity ... loop geom`` deterministic and decomposition-invariant, and we
reproduce it exactly so thermo tables match the reference logs digit for
digit.

These run on host (setup-time only), so plain numpy is the right tool.
"""

from __future__ import annotations

import numpy as np

IA = 16807
IM = 2147483647
AM = 1.0 / IM
IQ = 127773
IR = 2836


def park_next(seed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One Park-Miller step. seed: int64 array in [1, IM). Returns (seed', u)."""
    k = seed // IQ
    seed = IA * (seed - k * IQ) - IR * k
    seed = np.where(seed < 0, seed + IM, seed)
    return seed, AM * seed.astype(np.float64)


def jenkins_coord_seed(seed: int, coords: np.ndarray) -> np.ndarray:
    """Per-atom seeds from Jenkins one-at-a-time hash of (int seed, 3 doubles).

    Matches RanPark::reset(int, double*) in src/random_park.cpp:95-128,
    including its ``hash & 0x7ffffff`` (27-bit) truncation.
    coords: (N, 3) float64 array. Returns (N,) int64 seeds in [1, 2**27).
    """
    n = coords.shape[0]
    seed_bytes = np.frombuffer(
        np.int32(seed).tobytes(), dtype=np.uint8
    )  # little-endian, as on all target platforms
    coord_bytes = np.ascontiguousarray(coords, dtype="<f8").view(np.uint8).reshape(n, 24)
    buf = np.empty((n, 28), dtype=np.uint8)
    buf[:, :4] = seed_bytes[None, :]
    buf[:, 4:] = coord_bytes

    # the reference hashes through `char*`, which is SIGNED on the target
    # platforms: bytes >= 0x80 are sign-extended before the uint add
    signed = buf.view(np.int8).astype(np.int64)
    h = np.zeros(n, dtype=np.uint32)
    for i in range(28):
        h = h + signed[:, i].astype(np.uint32)  # int64 -> uint32 wraps mod 2^32
        h = h + (h << np.uint32(10))
        h = h ^ (h >> np.uint32(6))
    h = h + (h << np.uint32(3))
    h = h ^ (h >> np.uint32(11))
    h = h + (h << np.uint32(15))

    s = (h & np.uint32(0x7FFFFFF)).astype(np.int64)
    return np.where(s == 0, 1, s)


def geom_uniform_triplets(seed: int, coords: np.ndarray) -> np.ndarray:
    """The 3 uniforms per atom that ``velocity ... loop geom`` draws.

    Per atom: reset RNG from coord hash, warm up 5 draws
    (src/random_park.cpp:124-126), then draw 3 uniforms. Returns (N, 3).
    """
    s = jenkins_coord_seed(seed, coords)
    for _ in range(5):
        s, _ = park_next(s)
    out = np.empty((coords.shape[0], 3), dtype=np.float64)
    for d in range(3):
        s, u = park_next(s)
        out[:, d] = u
    return out


class RanPark:
    """Scalar sequential RanPark, for code paths that need a stream."""

    def __init__(self, seed: int):
        if seed <= 0:
            raise ValueError("Invalid seed for Park random # generator")
        self.seed = seed
        self._save = False
        self._second = 0.0

    def uniform(self) -> float:
        k = self.seed // IQ
        self.seed = IA * (self.seed - k * IQ) - IR * k
        if self.seed < 0:
            self.seed += IM
        return AM * self.seed

    def gaussian(self) -> float:
        if not self._save:
            while True:
                v1 = 2.0 * self.uniform() - 1.0
                v2 = 2.0 * self.uniform() - 1.0
                rsq = v1 * v1 + v2 * v2
                if rsq < 1.0 and rsq != 0.0:
                    break
            fac = np.sqrt(-2.0 * np.log(rsq) / rsq)
            self._second = v1 * fac
            self._save = True
            return v2 * fac
        self._save = False
        return self._second
