"""Marsaglia RNG (RanMars), bit-exact, with blocked vectorized generation.

The reference's RanMars (src/random_mars.cpp), as tpumd/utils/ranmars.py
has it: the subtract-with-carry lagged-Fibonacci generator that fix
langevin draws from.  The recurrence u[i97] = u[i97] - u[j97] touches
lag-separated slots, so ``fill`` produces draws in vectorized blocks,
bounded so that no read-after-write hazard occurs inside a block; the
carry sequence has a closed form.  Host numpy only.
"""

from __future__ import annotations

import numpy as np


class RanMars:
    def __init__(self, seed: int):
        if seed <= 0 or seed > 900000000:
            raise ValueError("Invalid seed for Marsaglia random # generator")
        u = np.zeros(98)
        ij = (seed - 1) // 30082
        kl = (seed - 1) - 30082 * ij
        i = (ij // 177) % 177 + 2
        j = ij % 177 + 2
        k = (kl // 169) % 178 + 1
        ell = kl % 169
        for ii in range(1, 98):
            s = 0.0
            t = 0.5
            for _ in range(24):
                m = ((i * j) % 179) * k % 179
                i, j, k = j, k, m
                ell = (53 * ell + 1) % 169
                if (ell * m) % 64 >= 32:
                    s += t
                t *= 0.5
            u[ii] = s
        self.u = u
        self.c = 362436.0 / 16777216.0
        self.cd = 7654321.0 / 16777216.0
        self.cm = 16777213.0 / 16777216.0
        self.i97 = 97
        self.j97 = 33
        self.uniform()  # the constructor burns one draw (random_mars.cpp:68)
        self._second = 0.0
        self._save = False

    def uniform(self) -> float:
        uni = self.u[self.i97] - self.u[self.j97]
        if uni < 0.0:
            uni += 1.0
        self.u[self.i97] = uni
        self.i97 -= 1
        if self.i97 == 0:
            self.i97 = 97
        self.j97 -= 1
        if self.j97 == 0:
            self.j97 = 97
        self.c -= self.cd
        if self.c < 0.0:
            self.c += self.cm
        uni -= self.c
        if uni < 0.0:
            uni += 1.0
        return uni

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

    def fill(self, n: int) -> np.ndarray:
        """n uniform draws, vectorized in hazard-free blocks."""
        out = np.empty(n)
        pos = 0
        while pos < n:
            i0, j0 = self.i97, self.j97
            L = min(i0, j0, n - pos)
            if i0 < j0:
                L = min(L, j0 - i0)
            if L <= 1:
                out[pos] = self.uniform()
                pos += 1
                continue
            t = np.arange(L)
            iw = i0 - t
            jr = j0 - t
            uni = self.u[iw] - self.u[jr]
            # no slot written in this block is read later in it (choice of
            # L), so the block equals L sequential draws
            uni = np.where(uni < 0.0, uni + 1.0, uni)
            self.u[iw] = uni
            cs = np.mod(self.c - (t + 1) * self.cd, self.cm)
            res = uni - cs
            res = np.where(res < 0.0, res + 1.0, res)
            out[pos:pos + L] = res
            self.i97 = i0 - L
            if self.i97 == 0:
                self.i97 = 97
            self.j97 = j0 - L
            if self.j97 == 0:
                self.j97 = 97
            self.c = cs[-1]
            pos += L
        return out
